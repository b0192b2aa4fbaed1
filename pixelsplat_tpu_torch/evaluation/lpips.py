"""LPIPS (VGG16 variant) as a frozen `nn.Module`.

Port of `pixelsplat_tpu/evaluation/lpips.py`, with the `lpips` package's
(net="vgg") parameter names: inputs scaled by the LPIPS scaling layer,
VGG16 features after the five ReLU stages, per-channel unit normalization,
squared differences, the learned 1x1 "lin" weights, spatial mean, sum over
stages.

Pretrained weights (VGG16 + lin heads) load from `weights/lpips_vgg.npz`
at the root of the checkout (kernels stored height, width, in, out; the
layout both packages read), which `scripts/export_weights.py` writes from
the published files. `load_lpips_published` reads those files directly:
the `lpips` package's lin file (`weights/v0.1/vgg.pth`) with torchvision's
VGG16 state_dict, or one full `lpips.LPIPS(net="vgg").state_dict()`.
Without the npz, `get_lpips(allow_random=True)` gives architecture-correct
random weights: fine for exercising code paths, not for metric parity.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

# VGG16 conv plan: (out_channels, pool_before).
VGG16_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# Conv indices after whose ReLU LPIPS taps features: relu1_2, relu2_2,
# relu3_3, relu4_3, relu5_3; conv i lies in slice SLICE_OF[i].
TAPS = [1, 3, 6, 9, 12]
SLICE_OF = [1, 1, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5]
# torchvision VGG16 `features` indices of the conv layers, in order.
TV_INDICES = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)

DEFAULT_WEIGHTS_PATH = Path(__file__).resolve().parents[2] / "weights" / "lpips_vgg.npz"


class _Lin(nn.Module):
    """The lpips package's NetLinLayer: `model.1` is the 1x1 conv (`model.0`
    is a dropout that is the identity at inference)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.ModuleDict({"1": nn.Conv2d(channels, 1, 1, bias=False)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model["1"](x)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        slices = {f"slice{n}": nn.ModuleDict() for n in range(1, 6)}
        in_ch = 3
        for i, (ch, _) in enumerate(VGG16_PLAN):
            slices[f"slice{SLICE_OF[i]}"][str(TV_INDICES[i])] = nn.Conv2d(in_ch, ch, 3, padding=1)
            in_ch = ch
        self.net = nn.ModuleDict(slices)
        self.lins = nn.ModuleList(_Lin(VGG16_PLAN[i][0]) for i in TAPS)
        self.register_buffer("shift", torch.tensor(SHIFT)[:, None, None], persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE)[:, None, None], persistent=False)
        self.requires_grad_(False)

    def _taps(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for i, (_, pool) in enumerate(VGG16_PLAN):
            if pool:
                x = torch.nn.functional.max_pool2d(x, 2, 2)
            x = torch.relu(self.net[f"slice{SLICE_OF[i]}"][str(TV_INDICES[i])](x))
            if i in TAPS:
                taps.append(x)
        return taps

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
        """img_a, img_b: (n, 3, h, w) in [0, 1] -> (n,) LPIPS distances."""

        def prep(img):
            return (img * 2.0 - 1.0 - self.shift) / self.scale  # lpips works on [-1, 1]

        total = 0.0
        for lin, fa, fb in zip(self.lins, self._taps(prep(img_a)), self._taps(prep(img_b))):
            na = fa / torch.sqrt((fa * fa).sum(1, keepdim=True) + 1e-10)
            nb = fb / torch.sqrt((fb * fb).sum(1, keepdim=True) + 1e-10)
            total = total + lin((na - nb) ** 2).mean(dim=(1, 2, 3))
        return total


def load_lpips(path: Optional[str] = None) -> Optional[LPIPS]:
    """The LPIPS module with the pretrained weights of the .npz, or None if
    the file is absent."""
    p = Path(path) if path else DEFAULT_WEIGHTS_PATH
    if not p.exists():
        return None
    data = np.load(p)
    sd = {}
    for i in range(len(VGG16_PLAN)):
        key = f"net.slice{SLICE_OF[i]}.{TV_INDICES[i]}"
        sd[f"{key}.weight"] = torch.from_numpy(data[f"vgg_conv{i}_kernel"].transpose(3, 2, 0, 1).copy())
        sd[f"{key}.bias"] = torch.from_numpy(np.array(data[f"vgg_conv{i}_bias"]))
    for i in range(len(TAPS)):
        sd[f"lins.{i}.model.1.weight"] = torch.from_numpy(
            data[f"lin{i}_kernel"].transpose(3, 2, 0, 1).copy()
        )
    model = LPIPS()
    model.load_state_dict(sd, strict=True)
    return model


def _load_pth(path) -> dict:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def _renamed_lin_and_vgg(lin: Mapping, vgg: Mapping) -> dict[str, torch.Tensor]:
    """The port's state_dict from the lin file (`lin{i}.model.1.weight`)
    and torchvision's VGG16 (`features.N.*`; its `classifier.*` unused)."""
    want_lin = {f"lin{i}.model.1.weight" for i in range(len(TAPS))}
    if set(lin) != want_lin:
        raise KeyError(f"LPIPS lin file: keys {sorted(lin)}, expected {sorted(want_lin)}")
    features = {f"features.{i}.{p}" for i in TV_INDICES for p in ("weight", "bias")}
    extra = [k for k in vgg if k not in features and not k.startswith("classifier.")]
    if not features <= set(vgg) or extra:
        raise KeyError(f"VGG16 state_dict: missing {sorted(features - set(vgg))}, unexpected {extra}")
    sd = {}
    for i, tv in enumerate(TV_INDICES):
        for p in ("weight", "bias"):
            sd[f"net.slice{SLICE_OF[i]}.{tv}.{p}"] = vgg[f"features.{tv}.{p}"]
    for i in range(len(TAPS)):
        sd[f"lins.{i}.model.1.weight"] = lin[f"lin{i}.model.1.weight"]
    return sd


def _renamed_full(full: Mapping) -> dict[str, torch.Tensor]:
    """The port's state_dict from `lpips.LPIPS(net="vgg").state_dict()`:
    `net.*` and `lins.*` as they are; `lin{i}.*` (the same modules under
    their attribute names) must equal `lins.{i}.*`; the scaling layer's
    buffers must hold SHIFT and SCALE."""
    sd = {k: v for k, v in full.items() if k.startswith(("net.", "lins."))}
    for i in range(len(TAPS)):
        key = f"lin{i}.model.1.weight"
        if key in full and not torch.equal(full[key], full[f"lins.{i}.model.1.weight"]):
            raise ValueError(f"LPIPS state_dict: {key} differs from lins.{i}.model.1.weight")
    for name, value in (("shift", SHIFT), ("scale", SCALE)):
        key = f"scaling_layer.{name}"
        if key in full and not torch.equal(full[key].reshape(-1), torch.tensor(value)):
            raise ValueError(f"LPIPS state_dict: {key} is {full[key].reshape(-1).tolist()}, not {value}")
    known = {f"lin{i}.model.1.weight" for i in range(len(TAPS))} | {"scaling_layer.shift", "scaling_layer.scale"}
    extra = sorted(k for k in full if k not in sd and k not in known)
    if extra:
        raise KeyError(f"LPIPS state_dict: unexpected keys {extra}")
    return sd


def load_lpips_published(
    lin_path: Optional[Union[str, Path]] = None,
    vgg_path: Optional[Union[str, Path]] = None,
    state_dict: Optional[Union[Mapping, str, Path]] = None,
) -> LPIPS:
    """The LPIPS module from the published files: the `lpips` package's lin
    file (`weights/v0.1/vgg.pth`) with torchvision's VGG16 state_dict
    (`vgg16-397923af.pth`), or one full `lpips.LPIPS(net="vgg")` state_dict
    (the dict, or a file that `torch.save` wrote). Loaded with `strict=True`."""
    if (state_dict is None) == (lin_path is None and vgg_path is None) or (lin_path is None) != (vgg_path is None):
        raise ValueError("give lin_path and vgg_path, or state_dict")
    if state_dict is not None:
        sd = _renamed_full(state_dict if isinstance(state_dict, Mapping) else _load_pth(state_dict))
    else:
        sd = _renamed_lin_and_vgg(_load_pth(lin_path), _load_pth(vgg_path))
    model = LPIPS()
    model.load_state_dict(sd, strict=True)
    return model


def lpips_npz_arrays(model: LPIPS) -> dict[str, np.ndarray]:
    """The arrays of `weights/lpips_vgg.npz` (what `load_lpips` reads):
    `vgg_conv{i}_kernel` / `_bias` and `lin{i}_kernel`, kernels height,
    width, in, out."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    out = {}
    for i in range(len(VGG16_PLAN)):
        key = f"net.slice{SLICE_OF[i]}.{TV_INDICES[i]}"
        out[f"vgg_conv{i}_kernel"] = sd[f"{key}.weight"].transpose(2, 3, 1, 0)
        out[f"vgg_conv{i}_bias"] = sd[f"{key}.bias"]
    for i in range(len(TAPS)):
        out[f"lin{i}_kernel"] = sd[f"lins.{i}.model.1.weight"].transpose(2, 3, 1, 0)
    return out


def random_lpips(seed: int = 0) -> LPIPS:
    """Architecture-correct random weights (tests and smoke runs): fan-in
    scaled normal kernels, zero biases."""
    model = LPIPS()
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, x in model.state_dict().items():
            if x.ndim == 4:
                x.copy_(torch.randn(x.shape, generator=generator) / math.sqrt(math.prod(x.shape[1:])))
            else:
                x.zero_()
    return model


def get_lpips(allow_random: bool = True) -> tuple[LPIPS, bool]:
    """(module in eval mode, whether its weights are the pretrained ones)."""
    model = load_lpips()
    if model is None:
        if not allow_random:
            raise FileNotFoundError(
                f"LPIPS weights not found at {DEFAULT_WEIGHTS_PATH}; write them from the published files "
                "with python -m pixelsplat_tpu_torch.scripts.export_weights --lpips-lin vgg.pth "
                "--vgg16 vgg16-397923af.pth"
            )
        return random_lpips().eval(), False
    return model.eval(), True
