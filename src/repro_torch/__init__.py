"""PyTorch / CUDA port of the SeerAttention-R system, for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: same module layout,
same head-major layouts at every public function, PyTorch inside. It
imports torch, never jax, and nothing of the reference package. Entry
points run on CUDA unless the caller asks for the CPU; on a CUDA tensor
every ported kernel runs as hand-written CUDA (``kernels/csrc``), on a
CPU tensor as its plain PyTorch version.
"""
