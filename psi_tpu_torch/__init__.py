"""psi_tpu_torch — the PSI pipeline in PyTorch for one NVIDIA Hopper card.

The counterpart of ``psi_tpu`` (JAX/XLA/Pallas), module for module:
``psi_tpu_torch.<sub>.<mod>`` ports ``psi_tpu.<sub>.<mod>``. Plain tensor
code is PyTorch; each Pallas kernel of ``psi_tpu`` on the ported path is
a CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built with ``nvcc`` on
first use and bound through ``ctypes`` (``ops/_cuda.py``). Every kernel
has a plain PyTorch twin in the same module: a CPU tensor takes the
twin, a CUDA tensor launches the kernel or raises.

This package imports torch and numpy only — never jax, flax, optax or
psi_tpu. Subpackages are imported explicitly; nothing is re-exported
here, so importing one module loads only what it needs.
"""

__version__ = "0.1.0"
