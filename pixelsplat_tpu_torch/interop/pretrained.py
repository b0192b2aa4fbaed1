"""Pretrained backbone trunks from exported torch.hub DINO weights.

Port of `pixelsplat_tpu/interop/pretrained.py`. The reference starts its
DINO ViT and its `dino_resnet50` trunk from the torch.hub DINO weights and
every pixelSplat head from random ones. The JAX package's
`tools/export_dino_weights.py` saves the raw hub state_dicts as
`weights/dino_vit*.npz` and `weights/dino_resnet50.npz`;
`init_backbone_from_pretrained` copies them into the encoder's trunks. The
port's modules keep the hub's parameter names (`dino.blocks.0.attn.qkv`,
`resnet_backbone.model.layer1.0.conv1`), so the graft is the hub tensors
under a prefix: no conversion. The ResNet branch's projections and the
token MLPs keep their initialization. A standalone `dino_resnet50`
backbone with five layers takes its hub `layer4` too, as the reference's
does; the JAX package's converter stops at `layer3` there.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch

WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "weights"


def save_state_dict_npz(sd: Mapping, path: Path) -> None:
    """Save a state_dict (numpy or torch values) as npz; keys keep their dots."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in sd.items()})


def load_state_dict_npz(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _hub_vit_path(model: str) -> Path:
    return WEIGHTS_DIR / f"{model}.npz"


def _hub_resnet_path() -> Path:
    return WEIGHTS_DIR / "dino_resnet50.npz"


def pretrained_trunks(backbone: torch.nn.Module) -> dict[str, tuple[str, torch.nn.Module]]:
    """The backbone's pretrained trunks whose weights are on disk: {prefix
    under the backbone: (file, module)}. Plain torchvision ResNets start
    random in the reference and have none."""
    from ..model.encoder.backbone.dino import BackboneDino
    from ..model.encoder.backbone.resnet import BackboneResnet

    trunks = {}
    resnet = backbone.resnet_backbone if isinstance(backbone, BackboneDino) else backbone
    if isinstance(backbone, BackboneDino):
        if not _hub_vit_path(backbone.cfg.model).exists():
            return trunks  # as the JAX package: no ViT file, no graft at all
        trunks["dino"] = (_hub_vit_path(backbone.cfg.model), backbone.dino)
    if isinstance(resnet, BackboneResnet) and resnet.cfg.model == "dino_resnet50" and _hub_resnet_path().exists():
        prefix = "resnet_backbone.model" if resnet is not backbone else "model"
        trunks[prefix] = (_hub_resnet_path(), resnet.model)
    return trunks


def init_backbone_from_pretrained(encoder: torch.nn.Module, encoder_cfg=None) -> int:
    """Copy the hub weights on disk into `encoder.backbone`'s trunks, in
    place; returns the number of tensors copied (0: no file on disk).

    Every tensor of a trunk must be in its file with the trunk's shape
    (KeyError, ValueError otherwise, before anything is copied); keys of
    the file that the trunk does not hold (the hub ResNet's `layer4`, its
    `num_batches_tracked`) are not read, as the JAX converters skip them.
    `encoder_cfg` is accepted for the JAX signature's sake; the backbone
    module carries its own.
    """
    plan = []
    for prefix, (path, module) in pretrained_trunks(encoder.backbone).items():
        hub = load_state_dict_npz(path)
        for name, tensor in module.state_dict().items():
            where = f"backbone.{prefix}.{name}"
            if name not in hub:
                raise KeyError(f"{where}: {name!r} is not in {path}")
            if tuple(hub[name].shape) != tuple(tensor.shape):
                raise ValueError(
                    f"shape mismatch at {where}: params {tuple(tensor.shape)} vs pretrained {tuple(hub[name].shape)}"
                )
            plan.append((tensor, hub[name]))
    with torch.no_grad():
        for tensor, value in plan:
            tensor.copy_(torch.from_numpy(np.asarray(value)))
    return len(plan)
