"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from
the root of the repository (card tests: ``-m cuda`` on a CUDA machine)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason: decided inside the test."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
