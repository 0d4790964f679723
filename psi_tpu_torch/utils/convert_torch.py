"""Reference torch checkpoints -> the port's modules.

Counterpart of ``psi_tpu.utils.convert_torch``, which converts the same
files to flax variables. The port's modules keep the reference checkpoints'
layer names, so loading is ``load_state_dict``; no layout changes.
Ported so far: the VPoser snapshot loader (decoder and, when the file
holds it, encoder; the VPoser trainer's snapshots are such files).
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict

import numpy as np
import torch

from psi_tpu_torch.body.vposer import VPoser
from psi_tpu_torch.utils.init import seeded_init_

_DECODER = ("bodyprior_dec_fc1", "bodyprior_dec_fc2", "bodyprior_dec_out")
_OPTIONAL = ("num_batches_tracked",)  # older torch wrote BatchNorm without it


def vposer_from_state_dict(sd: Dict[str, Any]) -> VPoser:
    """A VPoser sized from the ``bodyprior_dec_*`` entries of a reference
    state dict (tensors or numpy arrays, torch's [out, in] layout) and
    loaded with them. When the dict holds any ``bodyprior_enc_*`` entry it
    must hold the whole encoder, which is loaded too; a decoder-only dict
    leaves the encoder at a seeded construction (only decoding is then
    meaningful)."""
    want = [f"{name}.{leaf}" for name in _DECODER for leaf in ("weight", "bias")]
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"not a VPoser state dict: missing {missing}")
    dec = {k: torch.as_tensor(sd[k]).detach().float().cpu() for k in want}
    num_neurons, latentD = dec["bodyprior_dec_fc1.weight"].shape
    model = seeded_init_(VPoser(num_neurons=num_neurons, latentD=latentD,
                                num_joints=dec["bodyprior_dec_out.weight"].shape[0] // 6), 0)
    enc_keys = [k for k in model.state_dict() if k.startswith("bodyprior_enc_")]
    if any(k.startswith("bodyprior_enc_") for k in sd):
        missing = [k for k in enc_keys if k not in sd and k.rsplit(".", 1)[1] not in _OPTIONAL]
        if missing:
            raise KeyError(f"VPoser state dict with a partial encoder: missing {missing}")
        dec.update({k: torch.as_tensor(sd[k]).detach().cpu() for k in enc_keys if k in sd})
    result = model.load_state_dict(dec, strict=False)
    absent = [k for k in result.missing_keys if not (k.startswith("bodyprior_enc_") and k not in sd)]
    if absent or result.unexpected_keys:
        raise KeyError(f"VPoser state dict does not fit: missing {absent}, unexpected {result.unexpected_keys}")
    return model.eval()


def load_vposer(path: str, trusted: bool = False) -> VPoser:
    """Load VPoser from a snapshot dir (its mtime-newest snapshots/*.pt, the
    reference's expid2model convention; else the newest *.pt in the dir), a
    .pt file, or a converted .npz of the state dict. The counterpart of
    ``psi_tpu.utils.convert_torch.load_vposer_params``; returns the module in
    eval mode on the CPU.

    A .pt file is read with ``torch.load(weights_only=True)``, which takes a
    saved state dict (what the reference's snapshots are) and refuses
    anything that would run code. A file that holds a pickled module object
    instead is read only with ``trusted=True`` (``weights_only=False``: the
    unpickler runs what the file says, so only for a file you wrote), and
    its ``state_dict()`` is taken."""
    if path is None:
        raise ValueError("vposer path is None")
    if os.path.isdir(path):
        pts = sorted(glob.glob(os.path.join(path, "snapshots", "*.pt")), key=os.path.getmtime)
        if not pts:
            pts = sorted(glob.glob(os.path.join(path, "*.pt")), key=os.path.getmtime)
        if not pts:
            raise FileNotFoundError(f"no snapshots/*.pt or *.pt under {path}")
        path = pts[-1]
    if path.endswith(".npz"):
        return vposer_from_state_dict(dict(np.load(path)))
    sd = torch.load(path, map_location="cpu", weights_only=not trusted)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return vposer_from_state_dict(sd)
