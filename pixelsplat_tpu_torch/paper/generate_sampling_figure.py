"""Probabilistic-sampling figure: Gaussian cloud + depth-pdf density volume.

Port of `pixelsplat_tpu/paper/generate_sampling_figure.py`: loads a
checkpoint, encodes the figure scene deterministically while capturing the
monocular depth predictor's pdf and offset maps
(`EncoderEpipolar.capture_intermediates`), then renders two figures from
an orbit camera:

  gaussians.png: the Gaussians inside the first context camera's frustum,
    rendered orthographically (alpha, colour and premultiplied depth
    passes, one compositing launch each) with that frustum's wireframe
    composited over them.
  density.png: the predicted depth distribution as a volume: every
    orbit-camera ray is sampled densely, each sample looks up the
    (subdivided, offset-placed) pdf at its projected image position and
    disparity bucket, and the per-ray maximum becomes the density layer
    that is depth-composited with the wireframe.

Usage:
  python -m pixelsplat_tpu_torch.paper.generate_sampling_figure \\
      +experiment=re10k checkpointing.load=<ckpt> \\
      [--output sampling_figure] [--scene name:c0:c1:far] \\
      [--resolution 1536] [--samples-per-ray 2048] [--device cuda]

The density volume is plain PyTorch on the device, over blocks of rays
(the JAX package's is an XLA function over 4,096 rays at a time); each
ray's result depends on that ray alone, so the block size changes nothing.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..geometry.projection import get_world_rays, project, sample_image_grid
from ..model.encoder.epipolar.conversions import depth_to_relative_disparity
from ..utils.image_io import save_image
from ..visualization.drawing.cameras import unproject_frustum_corners
from .common import composite_depth_layers, frustum_lines, line_overlay_layers, load_model, load_scene
from .generate_point_cloud_figure import OrthographicPasses, _orbit_pose, encode_scene, figure_settings

# The published figure scene.
SCENES = (("fc60dbb610046c56", 0, 115, 9.0),)
LINE_WIDTH = 3.0
LINE_COLOR = (0.0, 0.0, 0.0)
POINT_DENSITY = 1.0
ANGLE = 30.0
SUBDIVISION = 32
DENSITY_COLOR = (80.0 / 255.0,) * 3
# Ray samples per block of the density volume (a multiple of any
# samples-per-ray up to 2^25 keeps whole rays in a block).
SAMPLES_PER_BLOCK = 1 << 25


def _frustum_planes(corners: np.ndarray, origin: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
    """(point on the plane, normal) of the 4 side planes and the far plane
    of a frustum, each normal pointing inside."""
    planes = []
    for i in range(4):
        ab = corners[i - 1] - corners[i]
        ac = origin - corners[i]
        planes.append((origin, np.cross(ab, ac)))
    ab = corners[0] - corners[1]
    ac = corners[2] - corners[1]
    planes.append((corners[0], np.cross(ac, ab)))
    return planes


def _frustum_mask(
    points: np.ndarray,  # (..., 3)
    corners: np.ndarray,  # (4, 3) far-plane corners of view 0
    origin: np.ndarray,  # (3,)
) -> np.ndarray:
    """Inside-ness against the 4 side planes + the far plane of the first
    context frustum."""
    inside = np.ones(points.shape[:-1], bool)
    for point, normal in _frustum_planes(corners, origin):
        inside &= np.einsum("...i,i->...", point - points, normal) > 0
    return inside


def _subdivided_pdf(pdf, offset) -> torch.Tensor:
    """(h, w, d) pdf + offsets -> (h, w, d*SUBDIVISION) with each bucket's
    mass placed at its predicted offset, on the pdf's device."""
    pdf, offset = torch.as_tensor(pdf), torch.as_tensor(offset, device=torch.as_tensor(pdf).device)
    h, w, d = pdf.shape
    chosen = torch.clip((offset * SUBDIVISION).to(torch.int64), 0, SUBDIVISION - 1)
    fine = torch.zeros((h, w, d, SUBDIVISION), dtype=pdf.dtype, device=pdf.device)
    fine.scatter_(-1, chosen[..., None], pdf[..., None])
    return fine.reshape(h, w, d * SUBDIVISION)


def density_volume(
    fine_pdf: torch.Tensor,  # (h, w, n_fine)
    origins: torch.Tensor,  # (r, 3) render rays
    directions: torch.Tensor,  # (r, 3)
    t: torch.Tensor,  # (s,) distances along each ray
    extrinsics: torch.Tensor,  # (4, 4) context view 0
    intrinsics: torch.Tensor,  # (3, 3)
    near: float,
    far: float,
    planes: list[tuple[np.ndarray, np.ndarray]],  # context view 0's frustum
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per ray: the largest pdf value among its samples inside the context
    frustum and image (0 elsewhere), and the depth of the first sample
    that reaches it plus 0.01 (so a line at that depth wins the tie), or
    1e20 where the largest value is below 0.05."""
    h, w, n_fine = fine_pdf.shape
    device = fine_pdf.device
    planes = [(torch.as_tensor(p, dtype=torch.float32, device=device),
               torch.as_tensor(n, dtype=torch.float32, device=device)) for p, n in planes]
    block = max(1, SAMPLES_PER_BLOCK // t.shape[0])
    results, depths = [], []
    for start in range(0, origins.shape[0], block):
        r_o, r_d = origins[start : start + block], directions[start : start + block]
        xyz = r_o[:, None] + r_d[:, None] * t[None, :, None]
        dpt = torch.linalg.vector_norm(xyz - extrinsics[:3, 3], dim=-1)
        dpt = depth_to_relative_disparity(dpt, near, far)
        img_xy, in_front = project(xyz, extrinsics, intrinsics)
        valid = in_front & (dpt > 0) & (dpt < 1) & (img_xy > 0).all(-1) & (img_xy < 1).all(-1)
        dpt_bucket = torch.clip((dpt * n_fine).to(torch.int32), 0, n_fine - 1)
        x_bucket = torch.clip((img_xy[..., 0] * w).to(torch.int32), 0, w - 1)
        y_bucket = torch.clip((img_xy[..., 1] * h).to(torch.int32), 0, h - 1)
        sampled = fine_pdf[y_bucket, x_bucket, dpt_bucket]
        inside = torch.ones(xyz.shape[:-1], dtype=torch.bool, device=device)
        for point, normal in planes:
            inside &= torch.einsum("...i,i->...", point - xyz, normal) > 0
        density = sampled * valid * inside
        # "Just take the max" instead of volume rendering; argmax keeps the
        # first of equal maxima.
        result = density.amax(dim=-1)
        sample_depth = t[density.argmax(dim=-1)] + 0.01
        depths.append(torch.where(result < 0.05, 1e20, sample_depth))
        results.append(result)
    return torch.cat(results), torch.cat(depths)


def generate_sampling_figure(
    encoder,
    example: dict,
    far: float,
    out: Path,
    resolution: int,
    samples_per_ray: int,
    settings,
) -> dict:
    """Write gaussians.png and density.png; returns the orthographic
    passes' record."""
    device = next(encoder.parameters()).device
    gaussians, _, captured = encode_scene(encoder, example, device)
    b, v, _, h, w = example["context"]["image"].shape
    spp = gaussians.means.shape[1] // (v * h * w)
    # (b, v, ray, srf, depth) -> view 0's (h, w, depth) maps.
    pdf = captured["pdf"][0, 0, :, 0].reshape(h, w, -1)
    offset = captured["offset"][0, 0, :, 0].reshape(h, w, -1)

    # Slightly zoomed intrinsics for a cleaner frustum.
    k = np.asarray(example["context"]["intrinsics"][0]).copy()
    k[..., :2, :2] *= 256.0 / (256.0 - 16.0)
    context_extrinsics = np.asarray(example["context"]["extrinsics"][0])
    corners = unproject_frustum_corners(
        torch.as_tensor(context_extrinsics), torch.as_tensor(k), torch.full((v,), far)
    ).numpy()
    origins_ctx = context_extrinsics[:, :3, 3]

    # Trim to the first context frustum.
    def to_grid(element) -> np.ndarray:
        element = element.cpu().numpy()[0].reshape(v, h, w, spp, *element.shape[2:])
        return np.moveaxis(element, 0, 3)

    means = to_grid(gaussians.means)
    mask = _frustum_mask(means, corners[0], origins_ctx[0])

    def trim(element) -> np.ndarray:
        return to_grid(element)[mask][None]

    render_extrinsics = _orbit_pose(context_extrinsics[0], ANGLE, far)
    t_means = trim(gaussians.means)
    passes = OrthographicPasses(
        t_means, trim(gaussians.covariances), trim(gaussians.harmonics), trim(gaussians.opacities),
        render_extrinsics, far, resolution, settings, device,
    )
    color, alpha, depth = passes.layers(t_means)
    print(passes.report("sampling figure"))

    # Only the first context frustum is drawn.
    lines = frustum_lines(context_extrinsics, k, np.full((v,), far, np.float32), max_views=1)
    line_layers = line_overlay_layers(
        lines, passes.view_extrinsics, passes.view_intrinsics, (resolution, resolution),
        LINE_WIDTH, LINE_COLOR, POINT_DENSITY, device=device,
    )
    layers = [tuple(torch.as_tensor(x, device=device) for x in (color, alpha, depth))]
    canvas = torch.ones_like(layers[0][0])
    image = composite_depth_layers(layers + line_layers, canvas)
    save_image(image.cpu().numpy(), out / "gaussians.png")
    print(f"Wrote {out / 'gaussians.png'}")

    # The density volume.
    xy, _ = sample_image_grid((resolution, resolution), device=device)
    origins, directions = get_world_rays(
        xy, torch.as_tensor(passes.view_extrinsics, device=device),
        torch.as_tensor(passes.view_intrinsics, device=device),
    )
    t = np.linspace(0.0, 1.0, samples_per_ray, dtype=np.float32)
    t = t * ((passes.view_far + 10.0) - (passes.view_near - 10.0)) + (passes.view_near - 10.0)
    density, sample_depth = density_volume(
        _subdivided_pdf(pdf, offset),
        origins.reshape(-1, 3),
        directions.reshape(-1, 3),
        torch.as_tensor(t, device=device),
        torch.as_tensor(example["context"]["extrinsics"][0, 0], device=device),
        torch.as_tensor(example["context"]["intrinsics"][0, 0], device=device),
        float(example["context"]["near"][0, 0]),
        float(example["context"]["far"][0, 0]),
        _frustum_planes(corners[0], origins_ctx[0]),
    )
    density = density.reshape(1, resolution, resolution).expand(3, -1, -1)
    sample_depth = sample_depth.reshape(1, resolution, resolution).expand(3, -1, -1)
    density_color = torch.tensor(DENSITY_COLOR, device=device)[:, None, None].expand(3, resolution, resolution)
    image = composite_depth_layers([(density_color, density, sample_depth)] + line_layers, canvas)
    save_image(image.cpu().numpy(), out / "density.png")
    print(f"Wrote {out / 'density.png'}")
    return passes.record


def main(argv: list[str]) -> list[dict]:
    """Write the figures of each scene; returns the orthographic passes'
    records."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--output", type=Path, default=Path("sampling_figure"))
    parser.add_argument("--scene", default=None, metavar="name:c0:c1:far")
    parser.add_argument("--resolution", type=int, default=1536)
    parser.add_argument("--samples-per-ray", type=int, default=2048)
    parser.add_argument("--capacity", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args, overrides = parser.parse_known_args(argv)

    cfg = load_config(["+experiment=re10k", "mode=test", *overrides])
    encoder, _ = load_model(cfg, args.device)
    if args.scene:
        scene, c0, c1, far = args.scene.split(":")
        scenes = [(scene, int(c0), int(c1), float(far))]
    else:
        scenes = list(SCENES)
    settings = figure_settings(cfg.model.decoder.render, args.capacity)

    records = []
    for scene, c0, c1, far in scenes:
        example = load_scene(cfg.dataset, scene, [c0, c1], [c0, c1])
        records.append(
            generate_sampling_figure(encoder, example, far, args.output, args.resolution, args.samples_per_ray, settings)
        )
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
