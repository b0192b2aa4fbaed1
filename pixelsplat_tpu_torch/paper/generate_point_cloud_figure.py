"""Gaussian point-cloud figures: orthographic renders with camera frusta.

Port of `pixelsplat_tpu/paper/generate_point_cloud_figure.py`: loads a
checkpoint, encodes each listed scene deterministically, trims the border
and far Gaussians, renders them orthographically from an orbit camera
(alpha, colour, and a premultiplied depth pass, one compositing launch
each), depth-composites the context cameras' frustum wireframes over the
render, exports a .ply of the trimmed Gaussians, and writes turbo-mapped
depth renders of the context views (the decoder: a colour and a depth
render per view).

Usage:
  python -m pixelsplat_tpu_torch.paper.generate_point_cloud_figure \\
      +experiment=re10k checkpointing.load=<ckpt> \\
      [--output point_clouds] [--scene name:c0:c1:far:angle] [--resolution N] [--device cuda]

Without --scene, the reference's published scene list is used.

The JAX package renders at fixed settings (`figure_settings`) and drops
the pairs they cannot hold; the port keeps them where the bounding-box
pre-pass shows they hold and grows them otherwise
(`ops/rasterizer/adaptive.py`: `probe`, `sufficient_settings`), so no pair is
dropped. The decoder's depth renders do the same from its settings.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..model.ply_export import export_ply
from ..ops.rasterizer.adaptive import probe, sufficient_settings
from ..ops.rasterizer.projection import aos_planes
from ..ops.rasterizer.render import RenderSettings, orthographic_frustum, render_orthographic
from ..utils.image_io import save_image
from ..visualization.color_map import apply_color_map_to_image
from .common import composite_depth_layers, frustum_lines, line_overlay_layers, load_model, load_scene

# scene, context 1, context 2, far plane, angles: the published figure
# scenes.
SCENES = (
    ("2c52d9d606a3ece2", 87, 112, 35.0, (105,)),
    ("71a1121f817eb913", 139, 164, 10.0, (65,)),
    ("d70fc3bef87bffc1", 67, 92, 10.0, (60,)),
    ("f0feab036acd7195", 44, 69, 25.0, (125,)),
    ("a93d9d0fd69071aa", 57, 82, 15.0, (60,)),
)
GAUSSIAN_TRIM = 8
LINE_WIDTH = 2.0
LINE_COLOR = (0.0, 0.0, 0.0)
POINT_DENSITY = 0.5


def figure_settings(render: RenderSettings, capacity: int | None) -> RenderSettings:
    """The JAX figure scripts' fixed settings: the tile capacity asked for
    (else the decoder's), a big list of an eighth of it (at least 32)."""
    capacity = capacity or render.capacity
    return RenderSettings(capacity=capacity, big_capacity=max(capacity // 8, 32))


def _parse_scene(spec: str):
    scene, c0, c1, far, angle = spec.split(":")
    return scene, int(c0), int(c1), float(far), (float(angle),)


def _orbit_pose(context_extrinsics: np.ndarray, angle: float, far: float) -> np.ndarray:
    """The render camera: the context view's frame rotated by `angle` about
    y, pitched -15 degrees, pushed back for visual balance."""
    from scipy.spatial.transform import Rotation

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rotation.from_euler("xyz", [-15.0, angle - 90.0, 0.0], True).as_matrix()
    translation = np.eye(4, dtype=np.float32)
    translation[2, 3] = far * 0.5 ** (1.0 / 3.0)  # 0.5x frustum volume
    return context_extrinsics @ (translation @ pose)


def encode_scene(encoder, example: dict, device) -> tuple:
    """The deterministic encode the figures start from: (Gaussians, the
    visualization dump, the captured intermediates)."""
    context = {k: torch.as_tensor(v, device=device) for k, v in example["context"].items()}
    dump: dict = {}
    with torch.no_grad(), encoder.capture_intermediates() as captured:
        gaussians = encoder(context, 0, True, visualization_dump=dump)
    return gaussians, dump, captured


class OrthographicPasses:
    """An orthographic view of trimmed Gaussians from `render_extrinsics`,
    `2 far` wide, at the settings its lists need: the alpha, colour and
    premultiplied depth passes the figures composite, one compositing
    launch each. `record` holds what a caller checks and reports."""

    def __init__(self, means, covariances, harmonics, opacities, render_extrinsics, far, resolution, settings, device):
        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

        self.means, self.covariances = t(means), t(covariances)
        self.harmonics, self.opacities = t(harmonics), t(opacities)
        self.camera = dict(
            extrinsics=t(render_extrinsics)[None],
            width=t([far * 2.0]),
            height=t([far * 2.0]),
            near=t([0.0]),
            far=t([far]),
        )
        self.image_shape = (resolution, resolution)
        frustum = orthographic_frustum(*self.camera.values())
        self.view_extrinsics = frustum[0][0].cpu().numpy()
        self.view_intrinsics = frustum[1][0].cpu().numpy()
        self.view_near, self.view_far = float(frustum[2][0]), float(frustum[3][0])
        occupancy = probe(*frustum[:3], aos_planes(self.means, self.covariances, self.opacities), self.image_shape,
                          settings, scale_invariant=False)
        self.settings = sufficient_settings(occupancy, settings, self.means.shape[1], self.image_shape)
        self.record = dict(
            gaussians=int(self.means.shape[1]), jax_settings=settings, settings=self.settings, dropped=[], camera=self.camera, image_shape=self.image_shape,
            scene=(self.means, self.covariances, self.harmonics, self.opacities),
        )

    def render(self, colors: torch.Tensor, use_sh: bool) -> np.ndarray:
        image, dropped = render_orthographic(
            *self.camera.values(), self.image_shape, colors.new_zeros((1, 3)), self.means, self.covariances,
            colors, self.opacities, use_sh=use_sh, settings=self.settings, return_overflow=True,
        )
        self.record["dropped"].append(int(dropped.sum()))
        return image[0].cpu().numpy()

    def layers(self, means: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(colour, alpha, straight-alpha depth) of the view; `means` are
        the trimmed means on the host, for the depth pass's values."""
        alpha = self.render(torch.ones_like(self.harmonics[..., 0]), use_sh=False)
        color = self.render(self.harmonics, use_sh=True)
        depth_vals = np.linalg.norm(means[0] - self.view_extrinsics[:3, 3], axis=-1)
        depth_colors = torch.as_tensor(np.repeat(depth_vals[None, :, None], 3, axis=2), device=self.means.device)
        depth_premultiplied = self.render(depth_colors, use_sh=False)
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = np.nan_to_num(depth_premultiplied / alpha, nan=1e10, posinf=1e10)
        return color, alpha, depth

    def report(self, label: str) -> str:
        s, j = self.settings, self.record["jax_settings"]
        return (
            f"{label}: {self.record['gaussians']} Gaussians at {self.image_shape[0]}x{self.image_shape[1]}; "
            f"the fixed settings are capacity {j.capacity}, big list {j.big_capacity}; rendered at capacity "
            f"{s.capacity}, big list {s.big_capacity}, pair budget {s.pair_budget}: dropped {self.record['dropped']}"
        )


def generate_scene_figure(
    encoder,
    decoder,
    example: dict,
    scene: str,
    far: float,
    angles,
    out_root: Path,
    idx: int,
    resolution: int,
    settings: RenderSettings,
) -> tuple[list[Path], dict]:
    """Write one scene's figures; returns the paths and a record of its
    renders ("orthographic": one `OrthographicPasses.record` per angle;
    "decoder": the context views' settings, dropped pairs, cameras and
    Gaussians)."""
    device = next(encoder.parameters()).device
    gaussians, dump, _ = encode_scene(encoder, example, device)

    b, v, _, h, w = example["context"]["image"].shape
    spp = gaussians.means.shape[1] // (v * h * w)

    # Trim low-quality border Gaussians and Gaussians beyond the far plane,
    # measured in the first context camera's space.
    def to_grid(element) -> np.ndarray:
        element = element.cpu().numpy()[0].reshape(v, h, w, spp, *element.shape[2:])
        return np.moveaxis(element, 0, 3)  # (h, w, spp, v, ...)

    means = to_grid(gaussians.means)
    w2c = np.linalg.inv(np.asarray(example["context"]["extrinsics"][0]))
    cam_means = np.einsum("vij,hwsvj->hwsvi", w2c[:, :3, :3], means) + w2c[:, :3, 3]
    mask = np.zeros(means.shape[:-1], bool)
    mask[GAUSSIAN_TRIM:-GAUSSIAN_TRIM, GAUSSIAN_TRIM:-GAUSSIAN_TRIM] = True
    mask &= cam_means[..., 2] < far

    def trim(element) -> np.ndarray:
        return to_grid(element)[mask][None]

    t_means = trim(gaussians.means)
    t_covariances = trim(gaussians.covariances)
    t_harmonics = trim(gaussians.harmonics)
    t_opacities = trim(gaussians.opacities)

    context_extrinsics = np.asarray(example["context"]["extrinsics"][0])
    context_intrinsics = np.asarray(example["context"]["intrinsics"][0])
    written, record = [], {"orthographic": []}
    base = out_root / f"{idx:0>6}_{scene}"

    for angle in angles:
        render_extrinsics = _orbit_pose(context_extrinsics[0], angle, far)
        passes = OrthographicPasses(
            t_means, t_covariances, t_harmonics, t_opacities, render_extrinsics, far, resolution, settings, device
        )
        color, alpha, depth = passes.layers(t_means)
        print(passes.report(f"{scene} angle {angle}"))
        record["orthographic"].append(passes.record)

        # Camera-frustum wireframe, occluded by the Gaussians.
        lines = frustum_lines(context_extrinsics, context_intrinsics, np.full((v,), far / 8.0, np.float32))
        layers = [tuple(torch.as_tensor(x, device=device) for x in (color, alpha, depth))]
        layers += line_overlay_layers(
            lines, passes.view_extrinsics, passes.view_intrinsics, (resolution, resolution),
            LINE_WIDTH, LINE_COLOR, POINT_DENSITY, device=device,
        )
        image = composite_depth_layers(layers, torch.ones_like(layers[0][0]))
        path = Path(f"{base}_angle_{angle:0>3}.png")
        save_image(image.cpu().numpy(), path)
        written.append(path)

    # .ply export of the trimmed Gaussians.
    export_ply(
        context_extrinsics[0],
        t_means[0],
        trim(dump["scales"])[0],
        trim(dump["rotations"])[0],
        t_harmonics[0],
        t_opacities[0],
        base / "gaussians.ply",
    )
    written.append(base / "gaussians.ply")

    # Turbo-mapped context-view depth renders.
    cameras = [torch.as_tensor(example["context"][k], device=device) for k in ("extrinsics", "intrinsics", "near", "far")]
    planes = aos_planes(gaussians.means[0], gaussians.covariances[0], gaussians.opacities[0])
    occupancy = probe(cameras[0][0], cameras[1][0], cameras[2][0], planes, (h, w), decoder.cfg.render)
    decoder_settings = sufficient_settings(occupancy, decoder.cfg.render, gaussians.means.shape[1], (h, w))
    with torch.no_grad():
        rendered = decoder(gaussians, *cameras, (h, w), depth_mode="depth", render_settings=decoder_settings)
    record["decoder"] = dict(
        views=v, settings=decoder_settings, jax_settings=decoder.cfg.render, dropped=int(rendered.overflow),
        cameras=cameras, image_shape=(h, w), scene=(gaussians.means, gaussians.covariances, gaussians.opacities),
    )
    print(f"{scene} context depth: rendered at capacity {decoder_settings.capacity}, big list "
          f"{decoder_settings.big_capacity}: dropped {int(rendered.overflow)}")
    result = rendered.depth.cpu().numpy()
    depth_near = np.log(np.quantile(result[result > 0], 0.01))
    depth_far = np.log(np.quantile(result, 0.99))
    result = 1.0 - (np.log(np.maximum(result, 1e-10)) - depth_near) / (depth_far - depth_near)
    for view in range(v):
        mapped = apply_color_map_to_image(result[0, view], "turbo")
        path = Path(f"{base}_depth_{view}.png")
        save_image(mapped, path)
        written.append(path)
    return written, record


def main(argv: list[str]) -> list[dict]:
    """Write every listed scene's figures; returns their records."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--output", type=Path, default=Path("point_clouds"))
    parser.add_argument(
        "--scene",
        action="append",
        default=None,
        metavar="name:c0:c1:far:angle",
        help="override the published scene list (repeatable)",
    )
    parser.add_argument("--resolution", type=int, default=1024)
    parser.add_argument("--capacity", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args, overrides = parser.parse_known_args(argv)

    cfg = load_config(["+experiment=re10k", "mode=test", *overrides])
    encoder, decoder = load_model(cfg, args.device)
    scenes = [_parse_scene(s) for s in args.scene] if args.scene else list(SCENES)
    settings = figure_settings(cfg.model.decoder.render, args.capacity)

    records = []
    for idx, (scene, c0, c1, far, angles) in enumerate(scenes):
        example = load_scene(cfg.dataset, scene, [c0, c1], [c0, c1])
        written, record = generate_scene_figure(
            encoder, decoder, example, scene, far, angles, args.output, idx, args.resolution, settings
        )
        for path in written:
            print(f"Wrote {path}")
        records.append(dict(record, written=written))
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
