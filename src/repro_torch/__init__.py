"""repro_torch — the diffusive graph engine ported from JAX/TPU to PyTorch
and hand-written CUDA kernels for Hopper (sm_90a).

It mirrors ``repro``'s module layout file for file and imports nothing of
it (``repro`` stays the reference the tests hold this package against).
Entry points run on the GPU unless the caller passes ``device="cpu"``;
each kernel wrapper takes its plain PyTorch version only for CPU tensors.
"""
