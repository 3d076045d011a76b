"""Hand-written CUDA kernels for Hopper, one module per kernel.

Each module holds the kernel's launch wrapper, its plain PyTorch version
and a launch count on the wrapper.  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.  Kernels are built from
``oisat_tpu_torch/csrc`` at first use (:mod:`._build`), never at import.
"""
