"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the device dispatch (``ops``). Nothing here builds or loads a kernel at
import time: ``build.load`` compiles at first use."""
