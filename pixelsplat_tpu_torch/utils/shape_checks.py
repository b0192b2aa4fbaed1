"""Shape checks at the encoder's and the renderer's entries.

Port of `pixelsplat_tpu/utils/shape_checks.py`, whose `chex` assertions run
at trace time. These read only `.shape` and `.ndim`, never a value, so
they add no device sync on the card; each raises ValueError naming the
tensor and its shape.
"""

from __future__ import annotations

import torch


def _fail(what: str, got: tuple, want: str) -> None:
    raise ValueError(f"{what}: shape {tuple(got)}, expected {want}")


def _rank(what: str, x: torch.Tensor, rank: int) -> None:
    if x.ndim != rank:
        _fail(what, x.shape, f"rank {rank}")


def _shape(what: str, x: torch.Tensor, want: tuple) -> None:
    if tuple(x.shape) != tuple(want):
        _fail(what, x.shape, str(tuple(want)))


def check_cameras(
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    batch_dims: int = 2,
) -> None:
    """(..., 4, 4) extrinsics, (..., 3, 3) intrinsics, (...) near and far."""
    _rank("extrinsics", extrinsics, batch_dims + 2)
    _rank("intrinsics", intrinsics, batch_dims + 2)
    _shape("extrinsics", extrinsics, (*extrinsics.shape[:-2], 4, 4))
    _shape("intrinsics", intrinsics, (*intrinsics.shape[:-2], 3, 3))
    _rank("near", near, batch_dims)
    _rank("far", far, batch_dims)
    if near.shape != far.shape:
        _fail("far", far.shape, f"near's {tuple(near.shape)}")


def check_gaussians(means, covariances, harmonics, opacities) -> None:
    """Gaussians (b, g, ...): means (b, g, 3), covariances (b, g, 3, 3),
    harmonics (b, g, 3, d_sh), opacities (b, g)."""
    _rank("means", means, 3)
    b, g, _ = means.shape
    _shape("means", means, (b, g, 3))
    _shape("covariances", covariances, (b, g, 3, 3))
    _rank("harmonics", harmonics, 4)
    _shape("harmonics", harmonics, (b, g, 3, harmonics.shape[-1]))
    _shape("opacities", opacities, (b, g))


def check_context(context: dict) -> None:
    """Batched context views: image (b, v, 3, h, w) and its cameras."""
    image = context["image"]
    _rank("context image", image, 5)
    b, v = image.shape[:2]
    _shape("context extrinsics", context["extrinsics"], (b, v, 4, 4))
    _shape("context intrinsics", context["intrinsics"], (b, v, 3, 3))
    _shape("context near", context["near"], (b, v))
    _shape("context far", context["far"], (b, v))
