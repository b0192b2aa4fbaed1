"""The GS-LRM encoder: context images -> one 3D Gaussian a pixel, from one
transformer over the patches of every context view at once.

GS-LRM (Zhang et al., "GS-LRM: Large Reconstruction Model for 3D Gaussian
Splatting", ECCV 2024, arXiv:2404.19702, sections 3-4: the scene model on
RealEstate10K) conditions on the cameras through its input: every pixel's
RGB beside its Plücker ray (o x d, d), in 8x8 patches through one linear
layer. Run here as three stages:

1. `encoder.backbone`: the Plücker ray of every pixel in world coordinates,
   its concatenation with the image, the patchify (each token a patch's
   pixels in (row, column, channel) order) and the patch's linear layer;
   the rays' origins and directions are kept for the heads.
2. `encoder.transformer`: `depth` pre-norm blocks (`backbone/dino.py`'s
   `ViTBlock`, so under the float32 policy on a card its four linear layers
   are K10) over the scene's v x (h / p) x (w / p) tokens as one sequence,
   so every token attends to every view's; then a LayerNorm.
3. `encoder.heads`: a linear layer to 12 channels a pixel of each patch and
   the unpatchify; then RGB, scale, rotation, opacity and the ray distance
   t. The Gaussian's mean is o + t d with t = near + (far - near)
   sigmoid(x); its scales min(exp(x - 2.3), 0.3) in world units; its
   rotation a normalized quaternion in the world frame; its opacity
   sigmoid(x - 2); its colour sigmoid(x), held as the degree-0 SH
   coefficient that renders to it. Then the packing.

No learned position embedding: the Plücker rays are the only position
signal. The head's constants are not fixed by the paper; they are the
configuration's `assumed` (`benchmark/configs/gslrm.json`).

It samples nothing: `forward` takes `EncoderEpipolar.forward`'s arguments
and ignores `deterministic`, `u`, `generator` and `view_order`. Only
float32 runs (`compute_dtype` None). On a CUDA device without autograd or a
visualization dump the stages run as CUDA graphs (`graphs.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional, Union

import torch
from torch import nn

from ...geometry.projection import plucker_rays
from ...ops import linear_kernel
from ...ops.rasterizer.projection import GaussiansSoA
from ...utils import tracing
from ...utils.shape_checks import check_context
from .. import precision
from ..types import Gaussians
from .backbone.dino import ViTBlock
from .common.gaussian_adapter import AdaptedGaussians
from .common.gaussians import build_world_covariance
from .common.packing import pack
from .graphs import EncoderGraphs, Stage, run_eagerly

# Channels a pixel in and out: RGB and the Plücker ray; RGB, scale,
# rotation, opacity and the ray distance.
IN_CHANNELS = 3 + 6
OUT_SPLIT = (3, 3, 4, 1, 1)
SH_C0 = 0.28209479177387814  # the degree-0 SH basis function
SCALE_SHIFT, SCALE_MAX = 2.3, 0.3
OPACITY_SHIFT = 2.0


@dataclass(frozen=True)
class EncoderGslrmCfg:
    """The fields of GS-LRM's scene model that change the forward pass, at
    its published RealEstate10K values."""

    name: Literal["gslrm"] = "gslrm"
    patch_size: int = 8
    d_model: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_ratio: int = 4
    num_context_views: int = 2
    sh_degree: int = 0
    # Only float32 (None) runs.
    compute_dtype: Optional[str] = None


class Transformer(nn.Module):
    """The blocks over one joint sequence, then the final LayerNorm."""

    def __init__(self, cfg: EncoderGslrmCfg):
        super().__init__()
        self.blocks = nn.ModuleList(ViTBlock(cfg.d_model, cfg.heads, cfg.mlp_ratio) for _ in range(cfg.depth))
        self.norm = precision.LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            tokens = block(tokens)
        return self.norm(tokens)


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(b, v, h, w, c) -> (b, v (h / p) (w / p), p p c) tokens, each a
    patch's pixels in (row, column, channel) order."""
    b, v, h, w, c = x.shape
    x = x.reshape(b, v, h // p, p, w // p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, v * (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, v: int, h: int, w: int, p: int) -> torch.Tensor:
    """`patchify`'s inverse: (b, v (h / p) (w / p), p p c) -> (b, v, h, w, c)."""
    b = x.shape[0]
    c = x.shape[-1] // (p * p)
    x = x.reshape(b, v, h // p, w // p, p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, v, h, w, c)


class EncoderGslrm(nn.Module):
    def __init__(self, cfg: EncoderGslrmCfg):
        super().__init__()
        if cfg.compute_dtype is not None:
            raise ValueError(f"the GS-LRM encoder computes in float32 only, not {cfg.compute_dtype!r}")
        if cfg.sh_degree != 0:
            raise ValueError(f"GS-LRM's Gaussians carry SH degree 0, not {cfg.sh_degree}")
        self.cfg = cfg
        p = cfg.patch_size
        self.tokenizer = precision.Linear(IN_CHANNELS * p * p, cfg.d_model)
        self.transformer = Transformer(cfg)
        self.head = precision.Linear(cfg.d_model, sum(OUT_SPLIT) * p * p)
        self._graphs = EncoderGraphs()

    def forward(
        self,
        context: dict,
        global_step: int,
        deterministic: bool = False,
        pack_soa: bool = False,
        u: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        view_order: Optional[torch.Tensor] = None,
        visualization_dump: Optional[dict] = None,
    ) -> Union[Gaussians, GaussiansSoA]:
        """Encode `context` (images (b, v, 3, h, w) and cameras) into one
        Gaussian a pixel; `pack_soa` as in `common/packing.py`.
        `global_step`, `deterministic`, `u`, `generator` and `view_order`
        change nothing. `visualization_dump`, when given, receives the ray
        distances, scales and rotations."""
        check_context(context)
        image = context["image"]
        b, v, _, h, w = image.shape
        p = self.cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"image size {h}x{w} is not a multiple of the patch size {p}")
        if v != self.cfg.num_context_views:
            raise ValueError(f"the encoder is configured for {self.cfg.num_context_views} context views, got {v}")
        inputs = {name: context[name] for name in ("image", "extrinsics", "intrinsics", "near", "far")}
        stages = self._stages(pack_soa, visualization_dump)
        if self._graphs.replays(image, None, visualization_dump, False):
            gaussians = self._graphs.run(self, stages, inputs, (pack_soa,))
        else:
            gaussians = run_eagerly(stages, inputs)
        tracing.count("gslrm_tokens", b * v * (h // p) * (w // p))
        tracing.count("gaussians", b * v * h * w)
        return gaussians

    def _stages(self, pack_soa: bool, visualization_dump: Optional[dict]) -> list[Stage]:
        """The encode as its three stages, on the inputs `forward` names:
        image, extrinsics, intrinsics, near and far."""

        def transformer(backbone):
            return self.transformer(backbone[0])

        def heads(features, backbone, near, far):
            return self._gaussians(features, *backbone[1:], near, far, pack_soa, visualization_dump)

        return [
            Stage("encoder.backbone", self._tokens, ("image", "extrinsics", "intrinsics"), "backbone"),
            Stage("encoder.transformer", transformer, ("backbone",), "features"),
            Stage("encoder.heads", heads, ("features", "backbone", "near", "far"), "gaussians"),
        ]

    def _tokens(self, image, extrinsics, intrinsics):
        """The stage `encoder.backbone`: (b, v, 3, h, w) images and their
        cameras -> ((b, v (h / p) (w / p), d_model) tokens, the rays'
        origins and directions, each (b, v, h, w, 3))."""
        h, w = image.shape[-2:]
        rays, origins, directions = plucker_rays(extrinsics, intrinsics, (h, w))  # rays (b, v, h, w, 6)
        pixels = torch.cat([image.permute(0, 1, 3, 4, 2), rays], dim=-1)
        return linear_kernel.linear(self.tokenizer, patchify(pixels, self.cfg.patch_size)), origins, directions

    def _gaussians(self, features, origins, directions, near, far, pack_soa, visualization_dump):
        """The stage `encoder.heads`: the head, the unpatchify, the
        activations and the packing."""
        b, v, h, w, _ = origins.shape
        raw = unpatchify(linear_kernel.linear(self.head, features), v, h, w, self.cfg.patch_size)
        rgb, scales, rotations, opacity, distance = raw.reshape(b, v, h * w, sum(OUT_SPLIT)).split(OUT_SPLIT, dim=-1)
        near, far = near[:, :, None, None], far[:, :, None, None]
        distance = near + (far - near) * torch.sigmoid(distance)  # (b, v, r, 1)
        means = origins.reshape(b, v, h * w, 3) + directions.reshape(b, v, h * w, 3) * distance
        scales = torch.clamp(torch.exp(scales - SCALE_SHIFT), max=SCALE_MAX)
        rotations = rotations / (torch.linalg.vector_norm(rotations, dim=-1, keepdim=True) + 1e-8)
        world = torch.eye(3, dtype=raw.dtype, device=raw.device)
        covariances = build_world_covariance(scales, rotations, world)
        harmonics = (torch.sigmoid(rgb) - 0.5) / SH_C0  # (b, v, r, 3): renders to sigmoid(rgb)
        opacities = torch.sigmoid(opacity - OPACITY_SHIFT)

        def surface(x):  # (b, v, r, ...) -> (b, v, r, 1 surface, 1 sample, ...)
            return x[:, :, :, None, None]

        gaussians = AdaptedGaussians(
            means=surface(means), covariances=surface(covariances), scales=surface(scales),
            rotations=surface(rotations), harmonics=surface(harmonics[..., None]), opacities=surface(opacities[..., 0]),
        )
        if visualization_dump is not None:
            visualization_dump["depth"] = distance.reshape(b, v, h, w, 1, 1)
            visualization_dump["scales"] = scales.reshape(b, -1, 3)
            visualization_dump["rotations"] = rotations.reshape(b, -1, 4)
        return pack(gaussians, gaussians.opacities, pack_soa)
