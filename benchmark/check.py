"""The comparison that decides `correct`: what the timed path produced,
against the configuration's plain reference model (`reference/<module>.py`,
found by `spec.reference_module`) and the plain rasterizer, run after the
window on the same inputs and weights, which the benchmark made from the
seed.

Every checked scene's rendered views against the reference's, each view by
the absolute difference over the reference view's RMS, the worst view of
the checked scenes: its median and 90th and 99th percentiles over the
view's pixels, which lower precision lifts everywhere, and its RMS, which
a fault confined to a few tiles or Gaussians lifts; and the scenes of the
window that dropped any (Gaussian, tile) pair. Where the reference module
defines `settle_draws`, the checked scenes' draws are first moved off its
discontinuities (`settle_depth_draws`; pixelSplat's depth uniforms off its
bucket edges), so that every pixel can be held.

`control.py` puts the reference in the program's place in the nearest
precision below the configuration's (TF32): the control that must come out
not correct.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import spec, weights as wts
from .reference import rasterizer as rast


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def reference_encoder(cfg: dict, seed: int, device) -> nn.Module:
    with torch.device(device):
        encoder = spec.reference_module(cfg).Encoder(cfg["encoder"])
    encoder.load_state_dict(wts.encoder_weights(wts.shapes_of(encoder), seed, device), strict=True)
    return encoder.eval()


def settle_depth_draws(units: list, cfg: dict, seed: int, device) -> list:
    """`units` as the reference module's `settle_draws` settles them, or as
    made where the module has none."""
    settle = getattr(spec.reference_module(cfg), "settle_draws", None)
    if settle is None:
        return units
    return settle(units, reference_encoder(cfg, seed, device), cfg["encoder"], device)


def reference_scene(encoder: nn.Module, cfg: dict, unit, device):
    """(images (V, 3, h, w), per-view Work) of one scene."""
    batch = _to(unit.batch, device)
    shimmed = spec.reference_module(cfg).apply_shims(batch, cfg["encoder"])
    with torch.no_grad():
        means, covs, harm, opac = encoder(shimmed["context"], 0, unit.u, unit.view_order)
        tgt = batch["target"]  # the dataset's bounds, as the protocol renders
        background = torch.tensor(cfg["decoder"]["background_color"], device=device)
        images, works = rast.render_views(
            means[0], covs[0], harm[0], opac[0], tgt["extrinsics"][0], tgt["intrinsics"][0], tgt["near"][0],
            tuple(cfg["image_shape"]), background,
        )
    return images, works


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """RMS of a - b over the RMS of b."""
    value = float(torch.sqrt(((a - b) ** 2).mean()) / torch.sqrt((b**2).mean()).clamp(min=1e-30))
    return value if math.isfinite(value) else 1e30


def gap_stats(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Quantiles of |a - b| over the RMS of b, and the RMS gap."""
    d = (a - b).abs().flatten().float()
    scale = float(torch.sqrt((b.float() ** 2).mean()).clamp(min=1e-30))
    q = torch.quantile(d[:: max(1, d.numel() // 1_000_000)], torch.tensor([0.5, 0.9, 0.99], device=d.device))
    out = {"median": float(q[0]) / scale, "p90": float(q[1]) / scale, "p99": float(q[2]) / scale,
           "max": float(d.max()) / scale, "rms": rel_rms(a, b)}
    return {k: (v if math.isfinite(v) else 1e30) for k, v in out.items()}


def check_eval(cell, run, seed: int, device) -> tuple[dict, dict, str]:
    """({check name: value}, {pool index: per-view Work}, a line of detail)."""
    cfg = cell.config
    encoder = reference_encoder(cfg, seed, device)
    units = run.outputs["units"]
    per_scene, works = [], {}
    for scene in run.outputs["scenes"]:
        images, work = reference_scene(encoder, cfg, units[scene["unit"]], device)
        works[scene["unit"]] = work
        stats = [gap_stats(p, r) for p, r in zip(scene["color"][0], images)]
        per_scene.append({k: max(st[k] for st in stats) for k in stats[0]})
    values = {f"image_gap_{k}": max(s[k] for s in per_scene) for k in ("median", "p90", "p99", "rms")}
    values["dropping_scenes"] = run.failed
    return values, works, f"image gaps per checked scene {per_scene}"


CHECKS = {"eval": check_eval}


def verdict(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} in the limits' order; every value must be
    at most its limit."""
    return {name: {"value": values[name], "limit": limit} for name, limit in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
