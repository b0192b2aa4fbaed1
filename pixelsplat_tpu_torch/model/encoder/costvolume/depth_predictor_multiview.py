"""MVSplat's depth predictor: a plane-sweep cost volume over the other
views, its refinement into a coarse disparity by a softmax over the
candidates, and a full-resolution refinement into depths and densities.

Everything runs in MVSplat's (v b) order on (v b, c, h, w) tensors. Each
stage of the encode is a method here (`cost_volume`, `refine_cost_volume`,
`refine_depth`); the Gaussian head `to_gaussians` is applied by the encoder.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.conv3x3_kernel import Conv3x3
from ..epipolar.epipolar_sampler import collect_other_views
from .unet import UNetModel

# MVSplat clamps the projected depth of a warped point before the division.
MIN_PROJECTED_DEPTH = 1e-3


def inverse_se3(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rigid transforms -> their inverses, in closed form."""
    r = m[..., :3, :3].transpose(-1, -2)
    t = -(r @ m[..., :3, 3:])
    return torch.cat([torch.cat([r, t], dim=-1), m[..., 3:, :]], dim=-2)


def inverse_intrinsics(k: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) upper-triangular intrinsics -> their inverses, in closed form."""
    fx, fy, s, cx, cy = k[..., 0, 0], k[..., 1, 1], k[..., 0, 1], k[..., 0, 2], k[..., 1, 2]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], -1),
            torch.stack([zero, 1.0 / fy, -cy / fy], -1),
            torch.stack([zero, zero, one], -1),
        ],
        dim=-2,
    )


def disparity_candidates(near: torch.Tensor, far: torch.Tensor, count: int) -> torch.Tensor:
    """(b, v) bounds -> (v b, count, 1, 1) disparities evenly spaced from
    1 / far to 1 / near."""
    lo, hi = 1.0 / far.transpose(0, 1).reshape(-1, 1), 1.0 / near.transpose(0, 1).reshape(-1, 1)
    steps = torch.linspace(0.0, 1.0, count, device=near.device, dtype=near.dtype)
    return (lo + steps[None] * (hi - lo))[..., None, None]


def warp_candidates(features, intrinsics, poses, depths):
    """Features of the other views sampled where each pixel of the
    reference view lands at each candidate depth.

    features (n, c, h, w) of the other view; intrinsics (n, 3, 3) of the
    reference view in feature pixels; poses (n, 4, 4) reference camera to
    other camera; depths (n, d). Returns (n, c, d, h, w)."""
    n, c, h, w = features.shape
    d = depths.shape[1]
    ys, xs = torch.meshgrid(
        torch.arange(h, device=features.device, dtype=features.dtype),
        torch.arange(w, device=features.device, dtype=features.dtype),
        indexing="ij",
    )
    grid = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(1, 3, h * w)
    points = poses[:, :3, :3] @ (inverse_intrinsics(intrinsics) @ grid)  # (n, 3, hw)
    points = points[:, :, None] * depths[:, None, :, None] + poses[:, :3, 3:, None]  # (n, 3, d, hw)
    points = (intrinsics @ points.reshape(n, 3, d * h * w)).reshape(n, 3, d, h * w)
    pixels = points[:, :2] / points[:, 2:].clamp(min=MIN_PROJECTED_DEPTH)
    x = 2 * pixels[:, 0] / (w - 1) - 1
    y = 2 * pixels[:, 1] / (h - 1) - 1
    sample_at = torch.stack([x, y], dim=-1).reshape(n, d * h, w, 2)
    warped = F.grid_sample(features, sample_at, mode="bilinear", padding_mode="zeros", align_corners=True)
    return warped.reshape(n, c, d, h, w)


class DepthPredictorMultiView(nn.Module):
    def __init__(self, cfg, gaussian_raw_channels: int):
        super().__init__()
        c, d = cfg.d_feature, cfg.num_depth_candidates
        self.num_depth_candidates = d
        self.upscale_factor = cfg.downscale_factor
        views = cfg.num_context_views

        width = cfg.costvolume_unet_feat_dim
        self.corr_refine_net = nn.Sequential(
            Conv3x3(d + c, width),
            nn.GroupNorm(8, width),
            nn.GELU(),
            UNetModel(width, tuple(cfg.costvolume_unet_channel_mult), tuple(cfg.costvolume_unet_attn_res), views),
            Conv3x3(width, d),
        )
        self.regressor_residual = nn.Conv2d(d + c, d, 1)
        # A convolution that a GELU follows applies it itself (`Conv3x3(gelu=True)`, K11's epilogue on
        # the card); the `nn.Identity` in the GELU's place keeps the parameters' names.
        self.depth_head_lowres = nn.Sequential(Conv3x3(d, 2 * d, gelu=True), nn.Identity(), Conv3x3(2 * d, d))

        self.upsampler = nn.Sequential(
            Conv3x3(2 * c, c),
            nn.Upsample(scale_factor=cfg.downscale_factor, mode="bilinear", align_corners=True),
            nn.GELU(),
        )
        width = cfg.depth_unet_feat_dim
        self.proj_feature = Conv3x3(c, width)
        self.refine_unet = nn.Sequential(
            Conv3x3(3 + width + 1 + 1, width),
            nn.GroupNorm(4, width),
            nn.GELU(),
            UNetModel(width, tuple(cfg.depth_unet_channel_mult), tuple(cfg.depth_unet_attn_res), views),
        )
        gpp = cfg.gaussians_per_pixel
        self.to_disparity = nn.Sequential(
            Conv3x3(width, 2 * width, gelu=True), nn.Identity(), Conv3x3(2 * width, 2 * gpp)
        )
        self.to_gaussians = nn.Sequential(
            Conv3x3(width + 3 + c, 2 * gaussian_raw_channels, gelu=True),
            nn.Identity(),
            Conv3x3(2 * gaussian_raw_channels, gaussian_raw_channels),
        )

    def cost_volume(self, features, intrinsics, extrinsics, near, far):
        """The stage `encoder.costvolume`: features (b, v, c, h, w) and the
        context cameras -> (cat[correlation averaged over the other views,
        features] (v b, D + c, h, w), disparity candidates (v b, D, 1, 1)).
        The correlation at a candidate is sum_c f_i * warped_j / sqrt(c)."""
        b, v, c, h, w = features.shape

        def vb(x):  # (b, v, ...) -> (v b, ...)
            return x.transpose(0, 1).reshape(v * b, *x.shape[2:])

        disparities = disparity_candidates(near, far, self.num_depth_candidates)
        k = vb(intrinsics).clone()
        k[:, 0] *= w
        k[:, 1] *= h
        feats = vb(features)
        others = collect_other_views(features, v)  # (b, v, v - 1, c, h, w)
        poses = inverse_se3(collect_other_views(extrinsics, v)) @ extrinsics[:, :, None]  # this camera to the other
        correlations = []
        for j in range(v - 1):
            warped = warp_candidates(vb(others[:, :, j]), k, vb(poses[:, :, j]), 1.0 / disparities[:, :, 0, 0])
            correlations.append((feats[:, :, None] * warped).sum(1) / math.sqrt(c))  # (v b, D, h, w)
        correlation = torch.stack(correlations).mean(0)
        return torch.cat([correlation, feats], dim=1), disparities

    def refine_cost_volume(self, volume, disparities):
        """The stage `encoder.cv_refine`: the refined cost volume's softmax
        over the candidates -> (the coarse disparity, its expectation,
        bilinearly upsampled, and `pdf_max`, the softmax's maximum,
        upsampled to the nearest), both (v b, 1, H, W) at full resolution."""
        refined = self.corr_refine_net(volume) + self.regressor_residual(volume)
        pdf = torch.softmax(self.depth_head_lowres(refined), dim=1)
        coarse = (disparities * pdf).sum(dim=1, keepdim=True)
        pdf_max = F.interpolate(pdf.max(dim=1, keepdim=True)[0], scale_factor=self.upscale_factor)
        full = F.interpolate(coarse, scale_factor=self.upscale_factor, mode="bilinear", align_corners=True)
        return full, pdf_max

    def refine_depth(self, features, cnn_features, images, disparity, pdf_max, near, far, gpp: int):
        """The stage `encoder.depth_refine`: (the refinement U-Net's output
        (v b, width, H, W), the upsampled features (v b, c, H, W), depths
        and densities (v b, gpp, H, W)); features and `cnn_features` are
        (b, v, c, h, w), `images` (b, v, 3, H, W)."""
        b, v = features.shape[:2]

        def vb(x):
            return x.transpose(0, 1).reshape(v * b, *x.shape[2:])

        upsampled = self.upsampler(torch.cat([vb(features), vb(cnn_features)], dim=1))
        refined = self.refine_unet(torch.cat([vb(images), self.proj_feature(upsampled), disparity, pdf_max], dim=1))
        delta, raw_density = self.to_disparity(refined).split(gpp, dim=1)
        lo = 1.0 / far.transpose(0, 1).reshape(v * b, 1, 1, 1)
        hi = 1.0 / near.transpose(0, 1).reshape(v * b, 1, 1, 1)
        depths = 1.0 / torch.clamp(disparity + delta, lo, hi)
        return refined, upsampled, depths, torch.sigmoid(raw_density)
