"""Architecture + run configuration dataclasses.

The port's copy of the reference's ``repro.configs.base`` (plain
dataclasses, no framework): one parametric model family covers the ten
LM-seed architectures, whose config modules live in ``contrib/configs/``.
A config fully determines parameter shapes, block pattern and input
specs; ``dtype`` stays the string ``"bfloat16"``. Reduced configs
(``.reduced()``) size CPU smoke tests; full configs feed the roofline
model's parameter counts (``repro_torch.roofline.model``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeCell", "SHAPE_CELLS"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | hybrid | ssm | vlm | moe | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention options
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope: bool = False  # multimodal 3D rope (qwen2-vl)
    sliding_window: Optional[int] = None  # beyond-paper long-ctx option

    # MoE
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    router_butterfly_metric: bool = False  # paper-technique diagnostic

    # SSM / hybrid (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0  # hybrid: shared attention block every k layers

    # RWKV6
    rwkv: bool = False

    # encoder-decoder (audio)
    enc_layers: int = 0  # >0 => encoder-decoder; n_layers = decoder layers

    # modality frontend stubs provide embeddings directly
    frontend_stub: bool = False

    # numerics
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.rwkv or (self.family == "ssm")

    @property
    def subquadratic(self) -> bool:
        """Can this config run the 500k-token decode cell?"""
        return (
            self.family in ("ssm", "hybrid")
            or self.rwkv
            or self.sliding_window is not None
        )

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_chunk=16,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            enc_layers=min(self.enc_layers, 2),
            sliding_window=min(self.sliding_window, 32)
            if self.sliding_window
            else None,
        )

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        qk = self.n_heads * hd * d + 2 * self.n_kv_heads * hd * d
        ao = self.n_heads * hd * d
        attn = qk + ao
        mlp = 3 * d * f
        if self.rwkv:
            per_layer = 4 * d * d + 2 * d * f + 6 * 2 * d * 64
        elif self.family in ("ssm", "hybrid") and self.ssm_state:
            d_in = self.ssm_expand * d
            mamba = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            per_layer = mamba
        else:
            per_layer = attn + mlp
        total = self.n_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            total += attn + mlp  # one shared attention block
        if self.is_moe:
            total = self.n_layers * (attn + self.n_experts * 3 * d * f)
            if self.dense_residual:
                total += self.n_layers * 3 * d * f
        if self.is_encdec:
            total += self.enc_layers * (attn + mlp) + self.n_layers * (
                attn + mlp
            )  # cross-attn approx included in attn*2? keep simple
        total += v * d  # tied embedding
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        hd = self.head_dim
        attn = (self.n_heads + 2 * self.n_kv_heads) * hd * d + self.n_heads * hd * d
        act = self.n_layers * (attn + self.top_k * 3 * d * f)
        if self.dense_residual:
            act += self.n_layers * 3 * d * f
        act += self.vocab * d
        return int(act)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)
