"""The one traffic generator: it reads a mix's parameters
(`traffic/<name>.json`) and the configuration's sizes and makes, from the
seed, the scenes a run sends.

Every scene is a rig of cameras along x (identity rotations, normalized
intrinsics with focal `focal` and the principal point at the centre):
`num_context_views` context cameras evenly spaced from 0 to the baseline
B, and `targets` target cameras between them, as the evaluation index
draws its targets between the context frames, each view with the
dataset's bounds `near` and `far`. B is one of a fixed, evenly spaced set
over `baseline` (re10k's loader scales every scene to B = 1), and the
targets' places, as fractions of B, are an evenly spaced set over
`target_span`; both are dealt in an order the seed shuffles, so every
seed sends the same set of sizes. Images are uniform noise made on the
host; the depth samples' uniforms `u` and, with more than two context
views, the epipolar transformer's view order are made on the device. A
seed gives the same traffic every time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .spec import sub_seed


@dataclass
class Unit:
    """One scene."""

    batch: dict  # raw views on the host: context / target -> image, extrinsics, intrinsics
    u: torch.Tensor  # (b, v, h*w, surfaces, gpp) on the device
    view_order: Optional[torch.Tensor]  # (v - 1,) on the device, or None


def dealt(span, count: int, seed: int, tag: str) -> list:
    """`count` evenly spaced values over `span`, in an order the seed
    shuffles."""
    lo, hi = span
    values = [lo + (hi - lo) * (i + 0.5) / count for i in range(count)]
    perm = torch.randperm(count, generator=torch.Generator().manual_seed(sub_seed(seed, tag)))
    return [values[i] for i in perm.tolist()]


def u_shape(config: dict, batch: int) -> tuple:
    """The shape of a scene's uniforms `u`: (batch, context views, h*w,
    surfaces, Gaussians a pixel); an encoder section without
    `num_surfaces` or `gaussians_per_pixel` counts each as 1."""
    enc = config["encoder"]
    h, w = config["image_shape"]
    return (batch, enc["num_context_views"], h * w, enc.get("num_surfaces", 1), enc.get("gaussians_per_pixel", 1))


def _cameras(positions: torch.Tensor, focal: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, 3) positions -> ((n, 4, 4) extrinsics, (n, 3, 3) intrinsics)."""
    n = positions.shape[0]
    extr = torch.eye(4).repeat(n, 1, 1)
    extr[:, :3, 3] = positions
    k = torch.tensor([[focal, 0.0, 0.5], [0.0, focal, 0.5], [0.0, 0.0, 1.0]])
    return extr, k.repeat(n, 1, 1)


def make_units(traffic: dict, config: dict, seed: int, device) -> list[Unit]:
    """The run's pool of scenes, `traffic["pool"]` of them, each a batch of
    `traffic["batch"]`."""
    enc = config["encoder"]
    h, w = config["image_shape"]
    v = enc["num_context_views"]
    b = traffic["batch"]
    n = traffic["pool"]
    focal = traffic["focal"]
    bs = dealt(traffic["baseline"], n * b, seed, "baselines")
    m = traffic["targets"]
    places = dealt(traffic["target_span"], n * b * m, seed, "targets")
    host = torch.Generator().manual_seed(sub_seed(seed, "images"))
    dev = torch.Generator(device=device).manual_seed(sub_seed(seed, "device_draws"))
    context_x = torch.linspace(0.0, 1.0, v)
    units = []
    for i in range(n):
        ctx_e, ctx_k, tgt_e, tgt_k = [], [], [], []
        for j in range(b):
            base = bs[i * b + j]
            e, k = _cameras(torch.stack([context_x * base, torch.zeros(v), torch.zeros(v)], -1), focal)
            ctx_e.append(e)
            ctx_k.append(k)
            xs = torch.tensor(sorted(places[(i * b + j) * m:(i * b + j + 1) * m])) * base
            e, k = _cameras(torch.stack([xs, torch.zeros(m), torch.zeros(m)], -1), focal)
            tgt_e.append(e)
            tgt_k.append(k)
        ctx_e, ctx_k, tgt_e, tgt_k = (torch.stack(x) for x in (ctx_e, ctx_k, tgt_e, tgt_k))
        images = torch.rand((b, v + tgt_e.shape[1], 3, h, w), generator=host)

        def views(image, e, k):
            n = e.shape[1]
            near = torch.full((b, n), float(traffic["near"]))
            return {"image": image, "extrinsics": e, "intrinsics": k, "near": near, "far": torch.full((b, n), float(traffic["far"]))}

        batch = {"context": views(images[:, :v], ctx_e, ctx_k), "target": views(images[:, v:], tgt_e, tgt_k)}
        u = torch.rand(u_shape(config, b), generator=dev, device=device)
        order = torch.randperm(v - 1, generator=dev, device=device) if v > 2 else None
        units.append(Unit(batch=batch, u=u, view_order=order))
    return units


def window_order(traffic: dict, seed: int) -> list:
    """The order in which the window sends the pool, cycled as long as it
    lasts: a seeded permutation."""
    gen = torch.Generator().manual_seed(sub_seed(seed, "order"))
    return torch.randperm(traffic["pool"], generator=gen).tolist()
