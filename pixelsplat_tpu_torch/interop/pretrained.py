"""Pretrained backbone trunks from exported torch.hub DINO weights.

Port of `pixelsplat_tpu/interop/pretrained.py`. The reference starts its
DINO ViT and its `dino_resnet50` trunk from the torch.hub DINO weights and
every pixelSplat head from random ones. `scripts/export_weights.py` saves
the hub modules' state_dicts as `weights/dino_vit*.npz` and
`weights/dino_resnet50.npz` (`export_hub_state_dict` reads the published
checkpoints on disk, as the hub loads them), and
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


def hub_module_state_dict(checkpoint: Mapping, name: str) -> dict[str, torch.Tensor]:
    """The state_dict of torch.hub's `facebookresearch/dino` module `name`
    once the hub has loaded `checkpoint` into it.

    A ViT (`dino_vitb8` from `dino_vitbase8_pretrain.pth`, `dino_vits16`
    from `dino_deitsmall16_pretrain.pth`, ...) loads strictly: the keys and
    shapes must be the module's. `dino_resnet50` (from
    `dino_resnet50_pretrain.pth`) is torchvision's ResNet-50 with `fc`
    replaced by the identity and loads non-strictly: `fc.*` is dropped, and
    a BatchNorm counter the file lacks keeps its initial 0. Any other key
    missing, unknown or of the wrong shape raises."""
    from ..model.encoder.backbone.dino import VIT_SPECS, DinoViT
    from ..model.encoder.backbone.resnet import BackboneResnet, BackboneResnetCfg

    with torch.device("meta"):
        if name == "dino_resnet50":  # all four stages: a five-layer backbone's trunk
            trunk = BackboneResnet(BackboneResnetCfg(model=name, num_layers=5)).model.state_dict()
            module = {}
            for key, value in trunk.items():  # torchvision's BatchNorm order: ..., running_var, num_batches_tracked
                module[key] = value
                if key.endswith("running_var"):
                    module[key[: -len("running_var")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
        else:
            spec = VIT_SPECS[name]
            module = DinoViT(spec["patch"], spec["dim"], spec["depth"], spec["heads"], 224 // spec["patch"]).state_dict()
    source = {k: v for k, v in checkpoint.items() if not (name == "dino_resnet50" and k.startswith("fc."))}
    unknown = sorted(set(source) - set(module))
    missing = sorted(k for k in module if k not in source and not (name == "dino_resnet50" and k.endswith("num_batches_tracked")))
    if unknown or missing:
        raise KeyError(f"{name}: checkpoint keys unknown to the hub module {unknown}, missing {missing}")
    out = {}
    for key, like in module.items():
        if key not in source:
            out[key] = torch.zeros((), dtype=torch.int64)
            continue
        value = torch.as_tensor(source[key])
        if tuple(value.shape) != tuple(like.shape):
            raise ValueError(f"{name}: {key} has shape {tuple(value.shape)}, the hub module {tuple(like.shape)}")
        out[key] = value.to(like.dtype)
    return out


def export_hub_state_dict(src: Path, name: str, out_dir: Path = WEIGHTS_DIR) -> Path:
    """Read the published hub checkpoint `src` for the model `name` and write
    `out_dir/<name>.npz` with the hub module's state_dict: the keys the JAX
    package's `tools/export_dino_weights.py` writes."""
    checkpoint = torch.load(Path(src), map_location="cpu", weights_only=True)
    path = Path(out_dir) / f"{name}.npz"
    save_state_dict_npz(hub_module_state_dict(checkpoint, name), path)
    return path


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
