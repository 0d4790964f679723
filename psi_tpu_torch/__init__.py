"""psi_tpu_torch — the PSI pipeline in PyTorch for one NVIDIA Hopper card.

The counterpart of ``psi_tpu`` (JAX/XLA/Pallas), module for module:
``psi_tpu_torch.<sub>.<mod>`` ports ``psi_tpu.<sub>.<mod>``. Plain tensor
code is PyTorch; each Pallas kernel of ``psi_tpu`` on the ported path is
a CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built with ``nvcc`` on
first use and bound through ``ctypes`` (``ops/_cuda.py``). Every kernel
has a plain PyTorch twin in the same module: a CPU tensor takes the
twin, a CUDA tensor launches the kernel or raises.

This package imports torch and numpy only — never jax, flax, optax or
psi_tpu. Importing it loads no subpackage: the top-level names below
(psi_tpu's convenience API) are resolved on first use from the module that
defines each, so importing one module loads only what it needs.
"""

__version__ = "0.1.0"

_LAZY = {
    "HumanCVAES1": "psi_tpu_torch.models.cvae_s1",
    "HumanCVAES2": "psi_tpu_torch.models.cvae_s2",
    "SMPLXModel": "psi_tpu_torch.body.smplx_model",
    "load_smplx_npz": "psi_tpu_torch.body.smplx_model",
    "smplx_forward": "psi_tpu_torch.body.smplx_model",
    "VPoser": "psi_tpu_torch.body.vposer",
    "SceneAssets": "psi_tpu_torch.train.objective",
    "TrainOP": "psi_tpu_torch.train.loop",
    "FittingOP": "psi_tpu_torch.fit.fitting",
    "fit_bodies": "psi_tpu_torch.fit.fitting",
    "TestOP": "psi_tpu_torch.gen.sample",
    "generate_bodies": "psi_tpu_torch.gen.sample",
    "GenerationEngine": "psi_tpu_torch.serve.engine",
    "chamfer_distance": "psi_tpu_torch.ops.chamfer",
    "sdf_trilinear": "psi_tpu_torch.ops.sdf",
}


def __getattr__(name):
    """Lazy top-level convenience API (keeps ``import psi_tpu_torch`` light)."""
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'psi_tpu_torch' has no attribute {name!r}")
