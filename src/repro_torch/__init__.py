"""PyTorch/CUDA port of the ParButterfly engine.

A second package beside the JAX reference ``repro``: exact butterfly
counting (global, per-vertex, per-edge), tip and wing peeling, the
approximate tier (``core.sparsify``, ``core.approx``) and the query
service (``serve``) end to end in PyTorch, with five kernels
hand-written in CUDA C++ for Hopper (``sm_90a``). Entry points run on
the CUDA card unless the caller passes ``device="cpu"``, where the
kernels' plain PyTorch versions run.
"""
