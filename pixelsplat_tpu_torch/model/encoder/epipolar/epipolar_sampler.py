"""Epipolar sampling: per-ray feature samples along other views' epipolar lines.

Port of `pixelsplat_tpu/model/encoder/epipolar/epipolar_sampler.py`. It has
no parameters, so it is a function. Each (view, other view) pair's source
image is gathered directly and sampled with one `grid_sample` call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ....geometry.epipolar_lines import project_rays
from ....geometry.projection import get_world_rays, sample_image_grid
from ....ops.grid_sample import grid_sample_nhwc_flat
from ....utils.pairings import generate_heterogeneous_index


class EpipolarSampling(NamedTuple):
    features: torch.Tensor  # (b, v, ov, ray, sample, channel)
    valid: torch.Tensor  # (b, v, ov, ray)
    xy_ray: torch.Tensor  # (b, v, ray, 2)
    xy_sample: torch.Tensor  # (b, v, ov, ray, sample, 2)
    xy_sample_near: torch.Tensor  # (b, v, ov, ray, sample, 2)
    xy_sample_far: torch.Tensor  # (b, v, ov, ray, sample, 2)
    origins: torch.Tensor  # (b, v, ray, 3)
    directions: torch.Tensor  # (b, v, ray, 3)


def collect_other_views(target: torch.Tensor, v: int) -> torch.Tensor:
    """(b, v, ...) -> (b, v, v-1, ...) selecting, per view, all other views."""
    _, index_other = generate_heterogeneous_index(v)
    return target[:, torch.as_tensor(index_other, device=target.device)]


def sample_along_epipolar_lines(
    images: torch.Tensor,  # (b, v, h, w, c) feature maps (channels-last)
    extrinsics: torch.Tensor,  # (b, v, 4, 4)
    intrinsics: torch.Tensor,  # (b, v, 3, 3)
    near: torch.Tensor,  # (b, v)
    far: torch.Tensor,  # (b, v)
    num_samples: int,
) -> EpipolarSampling:
    b, v, h, w, c = images.shape
    s = num_samples

    # Rays through every feature-grid pixel of every view.
    xy, _ = sample_image_grid((h, w), device=images.device, dtype=images.dtype)
    xy = xy.reshape(h * w, 2)
    # In the feature maps' dtype, as in the JAX package; the rays (and every
    # product with an f32 camera there) are f32.
    origins, directions = get_world_rays(xy.float(), extrinsics[:, :, None], intrinsics[:, :, None])  # (b, v, r, 3)

    projection = project_rays(
        origins[:, :, None],  # (b, v, 1, r, 3)
        directions[:, :, None],
        collect_other_views(extrinsics, v)[:, :, :, None],  # (b, v, ov, 1, 4, 4)
        collect_other_views(intrinsics, v)[:, :, :, None],
        near=near[:, :, None, None],
        far=far[:, :, None, None],
    )

    # Evenly spaced samples along each visible segment.
    sample_depth = (torch.arange(s, dtype=images.dtype, device=images.device) + 0.5) / s
    sample_depth = sample_depth[:, None]  # (s, 1)
    overlap = projection.overlaps_image[..., None].to(images.dtype)  # (b, v, ov, r, 1)
    xy_min = torch.nan_to_num(projection.xy_min, nan=0.0, posinf=0.0, neginf=0.0) * overlap
    xy_max = torch.nan_to_num(projection.xy_max, nan=0.0, posinf=0.0, neginf=0.0) * overlap
    xy_min = xy_min[..., None, :]  # (b, v, ov, r, 1, 2)
    xy_max = xy_max[..., None, :]
    xy_sample = xy_min + sample_depth * (xy_max - xy_min)

    # Sample features from the view each epipolar line lives in.
    # The taps' sums are f32 whatever the maps' dtype (bf16 taps times f32
    # weights in the JAX package).
    source_images = collect_other_views(images, v).float()  # (b, v, ov, h, w, c)
    coords = 2.0 * xy_sample - 1.0  # (b, v, ov, r, s, 2)
    features = grid_sample_nhwc_flat(
        source_images.reshape(b * v * (v - 1), h, w, c),
        coords.reshape(b * v * (v - 1), -1, s, 2),
    ).reshape(*coords.shape[:-1], c)  # (b, v, ov, r, s, c)

    # Zero out rays that don't overlap the other view at all.
    features = features * overlap[..., None]

    half_span = 0.5 / s
    return EpipolarSampling(
        features=features,
        valid=projection.overlaps_image,
        xy_ray=xy.expand(b, v, h * w, 2),
        xy_sample=xy_sample,
        xy_sample_near=xy_min + (sample_depth - half_span) * (xy_max - xy_min),
        xy_sample_far=xy_min + (sample_depth + half_span) * (xy_max - xy_min),
        origins=origins,
        directions=directions,
    )
