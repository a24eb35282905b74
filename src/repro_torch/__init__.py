"""PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports
neither it nor JAX. Module names follow ``repro`` so each port module
has an obvious counterpart. Entry points run on ``cuda`` unless the
caller asks for ``cpu``; every Pallas TPU kernel on a ported path is a
hand-written Hopper kernel under ``kernels/`` with a plain PyTorch
version beside it (the CPU path and the kernel's oracle).
"""
