"""PyTorch/CUDA port of the ParButterfly engine.

A second package beside the JAX reference ``repro``: exact butterfly
counting (global, per-vertex, per-edge), tip and wing peeling, round
checkpoints and distributed execution (``core.checkpoint``,
``core.distributed``, ``launch.mesh``), the approximate tier
(``core.sparsify``, ``core.approx``) and the query service (``serve``)
end to end in PyTorch, with five kernels
hand-written in CUDA C++ for Hopper (``sm_90a``). Entry points run on
the CUDA card unless the caller passes ``device="cpu"``, where the
kernels' plain PyTorch versions run.

Beside the engine, as in the reference: ``configs`` (the architecture
dataclasses and registry), ``roofline`` (the roofline model at the
H100's published rates, and its report CLI) and ``sharding`` (the
mesh-shape-only partition rules over the port's ``DeviceMesh``).
"""
