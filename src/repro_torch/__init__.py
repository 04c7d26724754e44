"""MARS raw-signal read mapping in PyTorch, with hand-written CUDA kernels
for the NVIDIA H100 (``kernels/``, sources in ``csrc/``).

A port of the JAX package ``repro``: the same modules, the same results bit
for bit.  It imports torch and numpy only.
"""
