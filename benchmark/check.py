"""The comparison that decides `correct`: what the timed path produced,
against the plain reference in `reference/`, run after the window on the
same inputs and weights, which the benchmark made from the seed.

Every checked scene's rendered views against the reference's, each view by
the absolute difference over the reference view's RMS, the worst view of
the checked scenes: its median and 90th and 99th percentiles over the
view's pixels, which lower precision lifts everywhere, and its RMS, which
a fault confined to a few tiles or Gaussians lifts; and the scenes of the
window that dropped any (Gaussian, tile) pair. The checked scenes' depth
uniforms are kept off the reference's bucket edges (`settle_depth_draws`),
so no Gaussian lands at another depth on one side and every pixel can be
held.

`control.py` puts the reference in the program's place in the nearest
precision below the configuration's (TF32): the control that must come out
not correct.
"""

from __future__ import annotations

import math

import torch

from . import weights as wts
from .reference import rasterizer as rast
from .reference.encoder import Encoder, apply_shims


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def reference_encoder(cfg: dict, seed: int, device) -> Encoder:
    with torch.device(device):
        encoder = Encoder(cfg["encoder"])
    encoder.load_state_dict(wts.encoder_weights(wts.shapes_of(encoder), seed, device), strict=True)
    return encoder.eval()


# Margin of a depth sample's uniform from the reference's bucket edges, far
# above float32 rounding of the cumulative distribution (~1e-6).
EDGE_MARGIN = 1e-5


def settle_depth_draws(units: list, cfg: dict, seed: int, device) -> list:
    """`units` with every depth uniform that lies within EDGE_MARGIN of an
    edge of the reference's cumulative bucket distribution moved to the
    middle of the nearest bucket at least twice the margin wide.

    Inverse-CDF sampling is discontinuous at the edges: there two correct
    float32 programs, which round the distribution differently, draw
    neighbouring buckets and place a Gaussian at another depth. The
    benchmark chooses its inputs away from the edges, so that the check
    measures the arithmetic and not where rounding falls."""
    from dataclasses import replace

    encoder = reference_encoder(cfg, seed, device)
    out = []
    for unit in units:
        context = apply_shims(_to(unit.batch, device), cfg["encoder"])["context"]
        with torch.no_grad():
            _, pdf, _ = encoder.depth_distribution(context, unit.view_order)
        upper = torch.cumsum(pdf, -1)  # (b, v, r, srf, buckets)
        lower = torch.cat([torch.zeros_like(upper[..., :1]), upper[..., :-1]], -1)
        middle = (0.5 * (lower + upper))[..., None, :]
        u = unit.u[..., :, None]  # (b, v, r, srf, gpp, 1)
        near_edge = (upper[..., None, :] - u).abs().amin(-1) < EDGE_MARGIN
        wide = ((upper - lower) >= 2 * EDGE_MARGIN)[..., None, :]
        choice = torch.where(wide, (middle - u).abs(), torch.full_like(middle.expand_as(wide), math.inf)).argmin(-1)
        settled = torch.gather(middle.expand(*choice.shape, middle.shape[-1]), -1, choice[..., None])[..., 0]
        out.append(replace(unit, u=torch.where(near_edge, settled, unit.u)))
    return out


def reference_scene(encoder: Encoder, cfg: dict, unit, device):
    """(images (V, 3, h, w), per-view Work) of one scene."""
    batch = _to(unit.batch, device)
    shimmed = apply_shims(batch, cfg["encoder"])
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
