"""A plain Gaussian-splatting rasterizer: the reference the program's
projection, binning and compositing kernels are judged against.

It follows the 3D Gaussian Splatting rasterizer (Kerbl et al. 2023) as
pixelSplat calls it: the world scaled by 1/near, EWA projection with the
frustum clamp and a 0.3 low-pass dilation, SH colours (+0.5, clamped at
0), the opacity-aware footprint, every (Gaussian, 16x16 tile) pair whose
ellipse reaches alpha >= 1/255 in the tile, each tile's pairs in exact
depth order, and front-to-back compositing in which a pixel skips alphas
under 1/255 and clamps alpha at 0.99. Its stop rule is the one pixelSplat's
tile rasterizer on the TPU defines, which the program follows: every pixel
of a tile takes every pair until all of the tile's pixels are under 1e-4
transmittance, and then the tile stops. (The CUDA rasterizer of 3DGS stops
each pixel before the Gaussian that would take it under 1e-4, which leaves
out up to 1e-2 of a colour where alpha is 0.99.) The program checks the
rule after each chunk of its lists, this reference after each pair: what
the program adds after that is under 1e-4 of a colour.

Besides the image it counts, per view, the work these inputs need from a
tile-parallel compositor: the pairs that reach some pixel of their tile
before the tile stops. The count depends only on the scene and the camera,
never on how a program sizes or pads its lists. It imports nothing of the
program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import geometry as geo
from .encoder import eval_sh_colors

TILE = 16
NEAR_CLIP = 0.2
DILATION = 0.3
MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.99
STOP_T = 1e-4
# Elements of one (tiles x slots x pixels) block.
BLOCK = 1 << 25


@dataclass
class Projected:
    x: torch.Tensor  # (g,) pixel coordinates, pixel centres at integers
    y: torch.Tensor
    conic: torch.Tensor  # (g, 3): a, b, c of the inverse 2D covariance
    depth: torch.Tensor  # (g,)
    color: torch.Tensor  # (g, 3)
    opacity: torch.Tensor  # (g,), 0 where culled
    radius: torch.Tensor  # (g, 2) footprint half-extents in pixels
    valid: torch.Tensor  # (g,) bool


@dataclass
class Work:
    """What one view's compositing needed."""

    pairs: int  # (Gaussian, tile) pairs that reached an open pixel
    gaussians: int  # distinct Gaussians among them
    pixels: int


def project(means, covs, harmonics, opacities, extrinsics, intrinsics, near, image_shape) -> Projected:
    """One view's screen-space Gaussians."""
    h, w = image_shape
    s = 1.0 / near
    cam = extrinsics.clone()
    cam[:3, 3] = cam[:3, 3] * s
    means = means * s
    covs = covs * s * s
    w2c = geo.inverse_se3(cam)
    r = w2c[:3, :3]
    p = means @ r.T + w2c[:3, 3]
    tx, ty, tz = p.unbind(-1)
    fx, fy = intrinsics[0, 0] * w, intrinsics[1, 1] * h
    cx, cy = intrinsics[0, 2] * w, intrinsics[1, 2] * h
    z = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    x_pix = fx * tx / z + cx - 0.5
    y_pix = fy * ty / z + cy - 0.5

    # EWA: J W Sigma W^T J^T with the Jacobian taken at the point clamped to
    # 1.3x the field of view.
    lim_x = 1.3 * 0.5 / intrinsics[0, 0]
    lim_y = 1.3 * 0.5 / intrinsics[1, 1]
    xc = torch.clamp(tx / z, -lim_x, lim_x)
    yc = torch.clamp(ty / z, -lim_y, lim_y)
    zero = torch.zeros_like(z)
    jac = torch.stack(
        [torch.stack([fx / z, zero, -fx * xc / z], -1), torch.stack([zero, fy / z, -fy * yc / z], -1)], -2
    )  # (g, 2, 3)
    t = jac @ r
    cov2 = t @ covs @ t.transpose(-1, -2)
    a = cov2[:, 0, 0] + DILATION
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + DILATION
    det = a * c - b * b
    safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / safe, -b / safe, a / safe], -1)

    cut = 2.0 * torch.log(torch.clamp(opacities, min=MIN_ALPHA) / MIN_ALPHA)
    radius = torch.ceil(torch.sqrt(torch.clamp(cut[:, None] * torch.stack([a, c], -1), min=0.0)))
    on_screen = (
        (x_pix + radius[:, 0] > 0) & (x_pix - radius[:, 0] < w) & (y_pix + radius[:, 1] > 0) & (y_pix - radius[:, 1] < h)
    )
    valid = (tz > NEAR_CLIP) & (det > 0) & (opacities > MIN_ALPHA) & on_screen

    view_dir = means - cam[:3, 3]
    view_dir = view_dir / torch.linalg.vector_norm(view_dir, dim=-1, keepdim=True)
    color = eval_sh_colors(harmonics, view_dir)
    return Projected(
        x=x_pix, y=y_pix, conic=conic, depth=tz, color=color,
        opacity=torch.where(valid, opacities, torch.zeros_like(opacities)),
        radius=radius, valid=valid,
    )


@torch.no_grad()
def tile_pairs(pr: Projected, image_shape):
    """Every (Gaussian, tile) pair whose ellipse reaches alpha >= 1/255 in
    the tile, grouped by tile and in exact depth order within it:
    (gaussian ids (P,), tile start (T,), tile count (T,))."""
    h, w = image_shape
    tw, th = -(-w // TILE), -(-h // TILE)
    dev = pr.x.device
    ids = torch.nonzero(pr.valid).squeeze(1)
    x, y, rad = pr.x[ids], pr.y[ids], pr.radius[ids]
    x0 = torch.clamp(torch.floor((x - rad[:, 0]) / TILE), 0, tw - 1).long()
    x1 = torch.clamp(torch.floor((x + rad[:, 0]) / TILE), 0, tw - 1).long()
    y0 = torch.clamp(torch.floor((y - rad[:, 1]) / TILE), 0, th - 1).long()
    y1 = torch.clamp(torch.floor((y + rad[:, 1]) / TILE), 0, th - 1).long()
    span_x = x1 - x0 + 1
    n = span_x * (y1 - y0 + 1)
    owner = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), n)
    k = torch.arange(owner.numel(), device=dev) - (torch.cumsum(n, 0) - n)[owner]
    tx = x0[owner] + k % span_x[owner]
    ty = y0[owner] + k // span_x[owner]

    # Smallest q = d^T conic d over the tile's pixel centres: 0 if the mean
    # is inside, else on one of the four edges. Kept where q <= the cut,
    # with a little slack; compositing tests every pixel exactly anyway.
    ca, cb, cc = (pr.conic[ids[owner], i] for i in range(3))
    ca, cc = ca.clamp(min=1e-12), cc.clamp(min=1e-12)
    mx, my = x[owner], y[owner]
    dx0 = tx.to(mx.dtype) * TILE - mx
    dx1 = dx0 + (TILE - 1)
    dy0 = ty.to(my.dtype) * TILE - my
    dy1 = dy0 + (TILE - 1)

    def q(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    qmin = torch.minimum(
        torch.minimum(q(dx0, torch.clamp(-cb * dx0 / cc, dy0, dy1)), q(dx1, torch.clamp(-cb * dx1 / cc, dy0, dy1))),
        torch.minimum(q(torch.clamp(-cb * dy0 / ca, dx0, dx1), dy0), q(torch.clamp(-cb * dy1 / ca, dx0, dx1), dy1)),
    )
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    cut = 2.0 * torch.log(torch.clamp(pr.opacity[ids[owner]], min=MIN_ALPHA) / MIN_ALPHA)
    keep = inside | (qmin <= cut * (1 + 1e-4) + 1e-4)
    gid = ids[owner[keep]]
    tile = (ty * tw + tx)[keep]

    order = torch.argsort(pr.depth[gid], stable=True)
    order = order[torch.argsort(tile[order], stable=True)]
    gid, tile = gid[order], tile[order]
    count = torch.bincount(tile, minlength=tw * th)
    start = torch.cumsum(count, 0) - count
    return gid, start, count


def _pixels(tiles: torch.Tensor, tw: int, dtype):
    within = torch.arange(TILE * TILE, device=tiles.device)
    px = (tiles % tw)[:, None] * TILE + within % TILE
    py = (tiles // tw)[:, None] * TILE + within // TILE
    return px.to(dtype), py.to(dtype)


def _composite_group(pr: Projected, gid, start, count, tiles, tw, background):
    """Composite a group of tiles: (rgb (n, 3, 256), needed pairs (n,),
    needed Gaussian ids)."""
    n = tiles.numel()
    px, py = _pixels(tiles, tw, pr.x.dtype)
    longest = int(count[tiles].max())
    step = max(1, min(longest, BLOCK // (n * TILE * TILE)))
    trans = torch.ones((n, TILE * TILE), dtype=pr.x.dtype, device=px.device)
    rgb = torch.zeros((n, 3, TILE * TILE), dtype=pr.x.dtype, device=px.device)
    needed = torch.zeros(n, dtype=torch.long, device=px.device)
    needed_ids = []
    for lo in range(0, longest, step):
        slot = lo + torch.arange(step, device=px.device)
        real = slot[None] < count[tiles][:, None]  # (n, L)
        g = gid[torch.where(real, start[tiles][:, None] + slot[None], 0)]
        dx = px[:, None, :] - pr.x[g][..., None]
        dy = py[:, None, :] - pr.y[g][..., None]
        con = pr.conic[g]
        power = -0.5 * (con[..., 0, None] * dx * dx + con[..., 2, None] * dy * dy) - con[..., 1, None] * dx * dy
        alpha = torch.clamp(pr.opacity[g][..., None] * torch.exp(power), max=MAX_ALPHA)
        alpha = torch.where((power <= 0) & (alpha >= MIN_ALPHA) & real[..., None], alpha, torch.zeros_like(alpha))
        t_before = trans[:, None, :] * torch.cumprod(
            torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]], dim=1), dim=1
        )
        # A tile takes a pair while some pixel is still at 1e-4 or above:
        # transmittance only falls, so the open pairs are a prefix.
        open_ = t_before.amax(-1) >= STOP_T  # (n, L)
        alpha = torch.where(open_[..., None], alpha, torch.zeros_like(alpha))
        rgb = rgb + torch.einsum("nlp,nlc->ncp", alpha * t_before, pr.color[g])
        use = open_ & (alpha > 0).any(-1)
        needed += use.sum(1)
        needed_ids.append(g[use])
        trans = trans * torch.prod(1.0 - alpha, dim=1)
        if bool((trans.amax(-1) < STOP_T).all()):
            break
    rgb = rgb + trans[:, None, :] * background[None, :, None]
    used = torch.cat(needed_ids) if needed_ids else gid.new_zeros(0)
    return rgb, needed, used


@torch.no_grad()
def render(pr: Projected, image_shape, background):
    """(image (3, h, w), Work) of one view, composited a group of tiles at a
    time."""
    h, w = image_shape
    if h % TILE or w % TILE:
        raise ValueError(f"image size {h}x{w} is not a multiple of {TILE}")
    tw, th = w // TILE, h // TILE
    gid, start, count = tile_pairs(pr, image_shape)
    order = torch.argsort(count, descending=True)
    image = torch.zeros((tw * th, 3, TILE * TILE), dtype=pr.x.dtype, device=pr.x.device)
    pairs = 0
    ids = []
    i = 0
    counts = count[order].tolist()
    while i < len(order):
        n = max(1, BLOCK // (max(counts[i], 1) * TILE * TILE))
        tiles = order[i:i + n]
        rgb, needed, used = _composite_group(pr, gid, start, count, tiles, tw, background)
        image[tiles] = rgb
        pairs += int(needed.sum())
        ids.append(used)
        i += n
    image = image.reshape(th, tw, 3, TILE, TILE).permute(2, 0, 3, 1, 4).reshape(3, th * TILE, tw * TILE)[:, :h, :w]
    work = Work(pairs=pairs, gaussians=int(torch.unique(torch.cat(ids)).numel()), pixels=h * w)
    return image, work


def render_views(means, covs, harmonics, opacities, extrinsics, intrinsics, near, image_shape, background):
    """Images (v, 3, h, w) and per-view Work of one scene's target views."""
    images, works = [], []
    for e, k, n in zip(extrinsics, intrinsics, near):
        pr = project(means, covs, harmonics, opacities, e, k, n, image_shape)
        image, work = render(pr, image_shape, background)
        images.append(image)
        works.append(work)
    return torch.stack(images), works
