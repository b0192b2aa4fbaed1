"""LPIPS (VGG16 variant) as a frozen `nn.Module`.

Port of `pixelsplat_tpu/evaluation/lpips.py`, with the `lpips` package's
(net="vgg") parameter names: inputs scaled by the LPIPS scaling layer,
VGG16 features after the five ReLU stages, per-channel unit normalization,
squared differences, the learned 1x1 "lin" weights, spatial mean, sum over
stages.

Pretrained weights (VGG16 + lin heads) load from the `.npz` that the JAX
package's `tools/export_lpips_weights.py` writes (`weights/lpips_vgg.npz`
at the root of the checkout; kernels stored height, width, in, out).
Without the file, `get_lpips(allow_random=True)` gives architecture-correct
random weights: fine for exercising code paths, not for metric parity.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

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
                f"LPIPS weights not found at {DEFAULT_WEIGHTS_PATH}; export them with the "
                "JAX package's tools/export_lpips_weights.py"
            )
        return random_lpips().eval(), False
    return model.eval(), True
