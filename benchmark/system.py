"""The system under test, built from the benchmark's inputs through the
program's own constructors: its CVAE, its VPoser, its SMPL-X model and its
scene assets (Morton-ordered clouds, corner-packed grids). This is the one
module of the harness, with the traffic generators, that imports the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _shapes(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _loaded(module: torch.nn.Module, weights: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    module = module.to_empty(device=device)
    module.load_state_dict(weights)
    return module.eval()


def _model_on_meta(model_type: str, cfg: Dict) -> torch.nn.Module:
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
    from psi_tpu_torch.models.cvae_s2 import HumanCVAES2

    with torch.device("meta"):
        if model_type == "s1":
            return HumanCVAES1(latentD=cfg["latentD"], n_dim_body=cfg["n_dim_body"], eps_d=cfg["eps_d"],
                               scene_in_channels=cfg["scene_in_channels"], image_size=cfg["image_size"])
        return HumanCVAES2(latentD_g=cfg["latentD_g"], latentD_l=cfg["latentD_l"], n_dim_body=cfg["n_dim_body"],
                           scene_in_channels=cfg["scene_in_channels"], image_size=cfg["image_size"])


def _vposer_on_meta(cfg: Dict) -> torch.nn.Module:
    from psi_tpu_torch.body.vposer import VPoser

    v = cfg["vposer"]
    with torch.device("meta"):
        return VPoser(num_neurons=v["num_neurons"], latentD=v["latentD"], num_joints=v["num_joints"])


def model_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    return _shapes(_model_on_meta(cfg["model_type"], cfg))


def vposer_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    return _shapes(_vposer_on_meta(cfg))


def build_model(cfg: Dict, weights: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    return _loaded(_model_on_meta(cfg["model_type"], cfg), weights, device)


def build_assets(cfg: Dict, body: Dict, vposer_w: Dict[str, torch.Tensor], scenes: Dict[str, torch.Tensor],
                 sdf_dtype, device):
    """The program's ``SceneAssets``: its registry Morton-orders the clouds
    on the host, ``make_assets`` packs the grids on the device."""
    from psi_tpu_torch.body.smplx_model import SMPLXModel
    from psi_tpu_torch.data.scenes import build_registry
    from psi_tpu_torch.data.synthetic import make_assets

    smplx = SMPLXModel(
        v_template=body["v_template"], shapedirs=body["shapedirs"], exprdirs=None, posedirs=body["posedirs"],
        J_regressor=body["J_regressor"], lbs_weights=body["lbs_weights"],
        hands_components_l=body["hands_components_l"], hands_components_r=body["hands_components_r"],
        pose_mean=body["pose_mean"], faces=torch.zeros((1, 3), dtype=torch.int64, device=device),
        parents=tuple(body["parents"]),
    )
    S = scenes["sdf"].shape[0]
    host = {k: scenes[k].cpu().numpy() for k in ("sdf", "grid_mins", "grid_maxs", "cloud")}
    registry = build_registry([f"scene{i}" for i in range(S)], list(host["cloud"]), list(host["sdf"]),
                              list(host["grid_mins"]), list(host["grid_maxs"]))
    vposer = _loaded(_vposer_on_meta(cfg), vposer_w, device)
    return make_assets(smplx, vposer, np.asarray(body["contact"].cpu()), registry, sdf_dtype=sdf_dtype, device=device)
