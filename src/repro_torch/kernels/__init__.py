"""The Sum-stage kernels: plans (``plan``), plain PyTorch versions
(``ref``), the CUDA sources under ``csrc/`` with their build (``build``),
and the wrappers the model calls (``ops``)."""
