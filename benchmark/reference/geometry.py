"""Camera geometry of the plain reference: rays, epipolar segments, depths.

A frozen copy of the camera conventions pixelSplat uses (OpenCV-style
camera-to-world extrinsics, intrinsics normalized by the image size) and of
its epipolar-segment case analysis, in plain PyTorch. It imports nothing of
the program under test.
"""

from __future__ import annotations

import math

import torch

F32_EPS = float(torch.finfo(torch.float32).eps)


def homogenize_points(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def homogenize_vectors(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)


def transform(points: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    return (matrix @ points[..., None])[..., 0]


def inverse_se3(extrinsics: torch.Tensor) -> torch.Tensor:
    r = extrinsics[..., :3, :3].transpose(-1, -2)
    t = -(r @ extrinsics[..., :3, 3:])
    bottom = torch.zeros_like(extrinsics[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([r, t], dim=-1), bottom], dim=-2)


def inverse_intrinsics(k: torch.Tensor) -> torch.Tensor:
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


def image_grid(h: int, w: int, device, dtype=torch.float32) -> torch.Tensor:
    """(h, w, 2) pixel-centre coordinates in [0, 1], xy order."""
    y = (torch.arange(h, device=device, dtype=dtype) + 0.5) / h
    x = (torch.arange(w, device=device, dtype=dtype) + 0.5) / w
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def world_rays(xy: torch.Tensor, extrinsics: torch.Tensor, intrinsics: torch.Tensor):
    """(origins, unit directions) through normalized image points."""
    d = transform(homogenize_points(xy), inverse_intrinsics(intrinsics))
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d = transform(homogenize_vectors(d), extrinsics)[..., :3]
    return extrinsics[..., :3, 3].expand(d.shape), d


def project_camera(points: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    points = points / (points[..., -1:] + F32_EPS)
    points = torch.nan_to_num(points, nan=0.0, posinf=1e8, neginf=-1e8)
    return transform(points, intrinsics)[..., :2]


def _in_bounds(xy, eps=1e-6):
    return ((xy >= -eps) & (xy <= 1 + eps)).all(dim=-1)


def _border(k, o, d, dim: int, value: float):
    """The ray's intersection with the image border line xy[dim] == value:
    (t, xy, valid)."""
    other = 1 - dim
    border = (value - k[..., dim, 2]) / k[..., dim, dim]
    t = (border * o[..., 2] - o[..., dim]) / (d[..., dim] - border * d[..., 2])
    coord = k[..., other, 2] + k[..., other, other] * (
        o[..., other] * (border * d[..., 2] - d[..., dim]) + d[..., other] * (o[..., dim] - border * o[..., 2])
    ) / (d[..., 2] * o[..., dim] - d[..., dim] * o[..., 2])
    same = torch.full_like(coord, value)
    xy = torch.stack([coord, same] if other == 0 else [same, coord], dim=-1)
    xyz = o + t[..., None] * d
    valid = _in_bounds(xy) & (xyz[..., 2] > -1e-6) & (t > -1e-6) & torch.isfinite(t)
    return t, xy, valid


def _pick(candidates, smallest: bool):
    t = torch.stack([c[0] for c in candidates])
    xy = torch.stack([c[1] for c in candidates])
    valid = torch.stack([c[2] for c in candidates])
    worst = math.inf if smallest else -math.inf
    t = torch.nan_to_num(torch.where(valid, t, torch.full_like(t, worst)), nan=worst, posinf=math.inf, neginf=-math.inf)
    best = t.amin(0) if smallest else t.amax(0)
    n = t.shape[0]
    order = torch.arange(n, device=t.device).reshape(n, *([1] * (t.ndim - 1)))
    first = torch.where(t == best[None], order, n).amin(0)
    return (
        best,
        torch.take_along_dim(xy, first[None, ..., None], 0)[0],
        torch.take_along_dim(valid, first[None], 0)[0],
    )


def _point(xyz, t, k):
    xy = project_camera(xyz, k)
    return t, xy, _in_bounds(xy) & (xyz[..., 2] > -1e-6) & (t > -1e-6)


def epipolar_segments(origins, directions, extrinsics, intrinsics, near, far):
    """The visible part [xy_min, xy_max] of each world ray's projection into
    another camera, clipped to the ray's [near, far]: (xy_min, xy_max,
    overlaps)."""
    w2c = inverse_se3(extrinsics)
    o = transform(homogenize_points(origins), w2c)[..., :3]
    d = transform(homogenize_vectors(directions), w2c)[..., :3]
    shape = torch.broadcast_shapes(o.shape[:-1], d.shape[:-1], intrinsics.shape[:-2])
    o, d = o.expand(*shape, 3), d.expand(*shape, 3)
    k = intrinsics.expand(*shape, 3, 3)
    borders = [_border(k, o, d, 0, 0.0), _border(k, o, d, 0, 1.0), _border(k, o, d, 1, 0.0), _border(k, o, d, 1, 1.0)]
    lo, hi = _pick(borders, True), _pick(borders, False)
    t_near = torch.as_tensor(near, dtype=o.dtype, device=o.device).expand(shape)
    t_far = torch.as_tensor(far, dtype=o.dtype, device=o.device).expand(shape)
    p0 = _point(o + t_near[..., None] * d, t_near, k)
    p1 = _point(o + t_far[..., None] * d, t_far, k)
    xy_min = torch.where(p0[2][..., None], p0[1], lo[1])
    xy_max = torch.where(p1[2][..., None], p1[1], hi[1])
    overlaps = (p0[2] | lo[2]) & (p1[2] | hi[2])
    return xy_min, xy_max, overlaps


def _solve3(a, b, eps=1e-20):
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    inv = 1.0 / torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [(c00 * b0 + c10 * b1 + c20 * b2) * inv, (c01 * b0 + c11 * b1 + c21 * b2) * inv,
         (c02 * b0 + c12 * b1 + c22 * b2) * inv],
        dim=-1,
    )


def sample_depths(origins, directions, xy, extrinsics, intrinsics):
    """Distance along each primary ray of the point its epipolar sample xy
    (in the other camera) lifts to: the least-squares meeting point of the
    two rays."""
    o2, d2 = world_rays(xy, extrinsics, intrinsics)
    o1, d1, o2, d2 = torch.broadcast_tensors(origins, directions, o2, d2)
    parallel = (d1 * d2).sum(-1) > 1 - 1e-5
    eye = torch.eye(3, dtype=o1.dtype, device=o1.device)
    n1 = d1[..., :, None] * d1[..., None, :] - eye
    n2 = d2[..., :, None] * d2[..., None, :] - eye
    lhs = n1 + n2 + parallel.to(o1.dtype)[..., None, None] * eye
    point = _solve3(lhs, transform(o1, n1) + transform(o2, n2))
    point = torch.where(parallel[..., None], torch.full_like(point, 1e10), point)
    return torch.linalg.vector_norm(point - o1, dim=-1)


def positional_encoding(x: torch.Tensor, octaves: int) -> torch.Tensor:
    """(..., d) in [0, 1] -> (..., d * octaves * 2): sin at 2 pi 2^o with
    phases 0 and pi/2, laid out (d, octave, phase)."""
    freq = 2.0 * math.pi * 2.0 ** torch.arange(octaves, dtype=x.dtype, device=x.device)
    phase = torch.tensor([0.0, 0.5 * math.pi], dtype=x.dtype, device=x.device)
    return torch.sin(x[..., None, None] * freq[:, None] + phase).reshape(*x.shape[:-1], -1)


def other_views(x: torch.Tensor, v: int) -> torch.Tensor:
    """(b, v, ...) -> (b, v, v - 1, ...): per view, every other view in order."""
    index = [[j for j in range(v) if j != i] for i in range(v)]
    return x[:, torch.tensor(index, device=x.device)]
