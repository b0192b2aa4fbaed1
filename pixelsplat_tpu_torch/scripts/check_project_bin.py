"""The projection, binning and occupancy kernels (`csrc/project_bin.cu`)
against their plain versions on the card, and their times.

    python -m pixelsplat_tpu_torch.scripts.check_project_bin [--models re10k re10k_3_view] [--no-time]

For each model's evaluation scene (`eval_scene.py`, seeded random weights)
it compares, on the same CUDA tensors:

* each target view's projection (the kernel against
  `project_gaussians_soa_plain` after the same 1/near rescale): the largest
  difference of each field over its largest magnitude, and how many
  Gaussians' `valid` or radii differ, which must stay within
  `PROJECTION_TOLERANCE` and `FLIPPED_SHARE`;
* the tile lists of every binning case (`binning_cases`) from the kernel's
  projected Gaussians: the kernels against `bin_gaussians_plain`, which must
  agree in every entry;
* the probe's integers (the occupancy kernel against `count_big` and
  `tile_occupancy` on the same projections), which must agree exactly.

Then it times each stage at the scene's shapes with CUDA events, the kernel
against its plain version, beside the bytes bound (each input read once and
each output written once, over 3.35 TB/s), and prints one JSON line. It
exits 1 on a projection outside its tolerance, or on any list or count
that differs.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace

import torch

from ..ops.rasterizer import adaptive, binning, project_bin_kernel
from ..ops.rasterizer.projection import (
    GaussiansSoA,
    ProjectedGaussians,
    project_gaussians_soa,
    project_gaussians_soa_plain,
    rescaled,
    soa_planes,
)
from ..ops.rasterizer.render import orthographic_frustum
from ..utils import tracing
from .eval_scene import card_line, cuda_ms, make_eval_scene

HBM_BYTES_PER_S = 3.35e12
# (big-list capacity, span) of the probe: the evaluation's, and one whose
# big list grows.
OCCUPANCY_CASES = ((256, 2), (8, 1))
FIELDS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "depth", "radius_x", "radius_y")
# The projection kernel against its plain version. Both round op by op, but
# the plain code inverts the camera with a matrix product and takes the field
# of view through `get_fov`'s ops, so the kernel's camera differs by ulps:
# every field and the colour within this share of its largest magnitude, and
# a Gaussian's `valid` or radius (a ceiling) different, where that moves it
# across an integer, for at most this share of the Gaussians.
PROJECTION_TOLERANCE = 1e-5
FLIPPED_SHARE = 1e-4


def scene_inputs(model: str, seed: int = 0) -> dict:
    """The model's evaluation scene on the card: its SoA Gaussians, the
    target cameras and the settings the probe chooses."""
    scene = make_eval_scene("cuda", seed=seed, model=model)
    gaussians = scene.encode(scene.batch, False, 0, generator=torch.Generator(device="cuda").manual_seed(seed))
    t = scene.target
    return {
        "model": model,
        "soa": GaussiansSoA(*(None if x is None else x[0] for x in gaussians)),
        "cams": (t["extrinsics"][0], t["intrinsics"][0], t["near"][0]),
        "image_shape": scene.image_shape,
        "settings": scene.choose(gaussians),
    }


@torch.no_grad()
def projection_pair(inputs: dict, view: int) -> tuple[ProjectedGaussians, ProjectedGaussians]:
    """(kernel, plain) projections of one target view."""
    e, k, n = (c[view] for c in inputs["cams"])
    kernel = project_gaussians_soa(e, k, inputs["image_shape"], inputs["soa"], n)
    plain = project_gaussians_soa_plain(*_rescaled_args(e, k, n, inputs))
    return kernel, plain


def _rescaled_args(e, k, n, inputs):
    e, soa = rescaled(e, inputs["soa"], n)
    return e, k, inputs["image_shape"], soa


def compare_projection(kernel: ProjectedGaussians, plain: ProjectedGaussians) -> dict:
    """Per field, max |kernel - plain| over the valid Gaussians of both,
    relative to the field's largest magnitude there; counts of Gaussians
    whose `valid` or radii differ."""
    both = kernel.valid & plain.valid
    out = {"gaussians": plain.valid.numel(), "valid": int(plain.valid.sum()),
           "valid_differ": int((kernel.valid != plain.valid).sum())}
    out["radius_differ"] = int(((kernel.radius_x != plain.radius_x) | (kernel.radius_y != plain.radius_y))[both].sum())
    for name in FIELDS[:6] + ("color",):
        a, b = getattr(kernel, name), getattr(plain, name)
        a, b = (a[..., both], b[..., both])
        scale = float(b.abs().max()) if b.numel() else 0.0
        out[name] = float((a - b).abs().max()) / scale if scale else 0.0
    return out


def projection_agrees(diff: dict) -> bool:
    """Whether a `compare_projection` record is within the tolerances."""
    return (all(diff[f] <= PROJECTION_TOLERANCE for f in FIELDS[:6] + ("color",))
            and diff["valid_differ"] + diff["radius_differ"] <= diff["gaussians"] * FLIPPED_SHARE)


def lists_equal(a: binning.TileLists, b: binning.TileLists) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def binning_cases(inputs: dict) -> list:
    """(name, projected, image_shape, bin_gaussians keyword arguments): the
    shapes every caller of the binning uses."""
    settings, shape = inputs["settings"], inputs["image_shape"]
    soa, (e, k, n) = inputs["soa"], inputs["cams"]
    chosen = dict(tile_size=16, capacity=settings.capacity, span=settings.span, big_capacity=settings.big_capacity,
                  chunk=settings.chunk, pair_budget=settings.pair_budget)
    with torch.no_grad():
        views = [project_gaussians_soa(e[v], k[v], shape, soa, n[v]) for v in range(e.shape[0])]
        depth = soa._replace(harmonics=None, colors=soa.mean_z[None].clone())
        depth_view = project_gaussians_soa(e[0], k[0], shape, depth, n[0])
        big = torch.full_like(n[:1], 1.0)
        oe, ok, _, _ = orthographic_frustum(e[:1], big * 2.0, big * 2.0, n[:1], n[:1] + 100.0)
        ortho = project_gaussians_soa(oe[0], ok[0], (1024, 1024), depth, None)
        xy = project_gaussians_soa(oe[0], ok[0], (256, 256), depth, None)
    cases = [(f"view {v}", p, shape, chosen) for v, p in enumerate(views)]
    cases += [
        ("view 0 wide keys", views[0], shape, {**chosen, "force_wide_keys": True}),
        ("view 0 span 3", views[0], shape, dict(capacity=2048, span=3, big_capacity=128, chunk=128)),
        ("view 0 depth colour", depth_view, shape, chosen),
        ("view 0 big overflow", views[0], shape, dict(capacity=512, span=1, big_capacity=8, chunk=64)),
        ("view 0 long big list", views[0], shape, dict(capacity=512, span=1, big_capacity=32768, chunk=64)),
        ("orthographic 1024x1024", ortho, (1024, 1024), dict(capacity=4096, span=2, big_capacity=256, chunk=128)),
        ("XY projection", xy, (256, 256), dict(capacity=2048, span=2, big_capacity=128, chunk=128)),
    ]
    return cases


@torch.no_grad()
def occupancy_pair(inputs: dict, big_capacity: int, span: int) -> tuple[tuple, tuple]:
    """The probe's (big-list capacity, max count, budget) over the target
    views from the kernels, and from `count_big` and `tile_occupancy` on the
    same (kernel) projections."""
    s = replace(inputs["settings"], span=span)
    e, k, n = inputs["cams"]
    shape = inputs["image_shape"]
    planes = soa_planes(inputs["soa"])
    max_count, budget, chosen = adaptive.probe(e, k, n, planes, shape, replace(s, big_capacity=big_capacity))
    rows, valid = project_bin_kernel.project(e, k, n, planes, shape)
    views = [ProjectedGaussians(*rows[:, v], color=None, opacity=planes[9], valid=valid[v]) for v in range(e.shape[0])]
    n_big = max(int(binning.count_big(p, shape, s.tile_size, s.span)) for p in views)
    plain_capacity = big_capacity if n_big <= big_capacity else -(-n_big // s.chunk) * s.chunk
    plain = [binning.tile_occupancy(p, shape, s.tile_size, s.span, plain_capacity, s.chunk) for p in views]
    return (chosen, max_count, budget), (
        plain_capacity, max(int(m) for m, _ in plain), max(int(b) for _, b in plain)
    )


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@torch.no_grad()
def time_stages(inputs: dict) -> dict:
    """Milliseconds a call of each stage, kernel and plain, at the scene's
    shapes (target view 0; the probe over every view), with each bound."""
    soa, shape, s = inputs["soa"], inputs["image_shape"], inputs["settings"]
    e, k, n = inputs["cams"]
    planes = soa_planes(soa)
    kw = dict(tile_size=s.tile_size, capacity=s.capacity, span=s.span, big_capacity=s.big_capacity, chunk=s.chunk,
              pair_budget=s.pair_budget)
    projected = project_gaussians_soa(e[0], k[0], shape, soa, n[0])
    tiles = binning.bin_gaussians(projected, shape, **kw)
    planes_bytes = _bytes(*planes[:3], soa.cov, planes[9])
    project_out = _bytes(*(getattr(projected, f) for f in FIELDS), projected.color, projected.valid)
    binned = _bytes(*(getattr(projected, f) for f in FIELDS), projected.opacity, projected.valid)
    out = {
        "project": dict(
            ms=cuda_ms(lambda: project_gaussians_soa(e[0], k[0], shape, soa, n[0]), iters=50, warmup=5),
            plain_ms=cuda_ms(lambda: project_gaussians_soa_plain(*_rescaled_args(e[0], k[0], n[0], inputs)), iters=10),
            bound_ms=(planes_bytes + _bytes(soa.harmonics) + project_out) / HBM_BYTES_PER_S * 1e3,
        ),
        "bin": dict(
            ms=cuda_ms(lambda: binning.bin_gaussians(projected, shape, **kw), iters=50, warmup=5),
            plain_ms=cuda_ms(lambda: binning.bin_gaussians_plain(projected, shape, **kw), iters=10),
            bound_ms=(binned + _bytes(*tiles)) / HBM_BYTES_PER_S * 1e3,
        ),
    }
    # Every Gaussian that spans two tiles is big at span 1: the big list's
    # selection sees most of the scene, as a training render's may (one
    # reached 57,344 big Gaussians), with a short big list and with one of
    # training's length.
    n_big = int(binning.count_big(projected, shape, s.tile_size, 1))
    for name, big_capacity in (("bin_many_big", 8), ("bin_many_big_long_list", 32768)):
        big = dict(capacity=512, span=1, big_capacity=big_capacity, chunk=64)
        tiles = binning.bin_gaussians(projected, shape, **big)
        out[name] = dict(
            ms=cuda_ms(lambda: binning.bin_gaussians(projected, shape, **big), iters=10, warmup=2),
            plain_ms=cuda_ms(lambda: binning.bin_gaussians_plain(projected, shape, **big), iters=5),
            bound_ms=(binned + _bytes(*tiles)) / HBM_BYTES_PER_S * 1e3, big_gaussians=n_big,
        )

    def probe(kernel: bool):
        with torch.enable_grad():
            # A plane that needs a gradient sends the probe down the plain path.
            p = planes if kernel else (planes[0].detach().requires_grad_(), *planes[1:])
            return adaptive.probe(e, k, n, p, shape, replace(s, big_capacity=256))

    out["occupancy"] = dict(
        ms=cuda_ms(lambda: probe(True), iters=20, warmup=3),
        plain_ms=cuda_ms(lambda: probe(False), iters=5),
        bound_ms=planes_bytes / HBM_BYTES_PER_S * 1e3,
    )
    return out


def check(models=("re10k", "re10k_3_view"), time: bool = True, seed: int = 0) -> dict:
    """Every comparison above for each model; with `time`, the stage times
    at each model's shapes. Returns the record."""
    record = {"models": {}}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for model in models:
        inputs = scene_inputs(model, seed)
        r = {"settings": {f: getattr(inputs["settings"], f) for f in ("capacity", "big_capacity", "pair_budget")}}
        r["projection"] = [compare_projection(*projection_pair(inputs, v)) for v in range(inputs["cams"][0].shape[0])]
        r["lists"] = {}
        for name, projected, shape, kw in binning_cases(inputs):
            tracing.reset()
            kernel = binning.bin_gaussians(projected, shape, **kw)
            launched = tracing.counter("bin_launches")
            plain = binning.bin_gaussians_plain(projected, shape, **kw)
            r["lists"][name] = dict(equal=lists_equal(kernel, plain), launches=launched,
                                    overflow=int(plain.overflow), pairs=int(plain.counts.sum()))
        r["occupancy"] = {f"{bc} span {span}": occupancy_pair(inputs, bc, span) for bc, span in OCCUPANCY_CASES}
        if time:
            r["times"] = time_stages(inputs)
        record["models"][model] = r
    record["ok"] = all(
        all(projection_agrees(v) for v in r["projection"])
        and all(c["equal"] and c["launches"] == 1 for c in r["lists"].values())
        and all(kernel == plain for kernel, plain in r["occupancy"].values())
        for r in record["models"].values()
    )
    return record


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", nargs="+", default=["re10k", "re10k_3_view"])
    parser.add_argument("--no-time", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("check_project_bin needs an NVIDIA GPU")
    print(card_line(), "| torch", torch.__version__)
    record = check(args.models, not args.no_time)
    print(json.dumps(record))
    sys.exit(0 if record["ok"] else 1)


if __name__ == "__main__":
    main()
