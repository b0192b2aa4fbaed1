"""Shared helpers for the paper figure generators.

Port of `pixelsplat_tpu/paper/common.py`: the checkpoint and scene plumbing
every figure script starts with (load a model, pin the dataset to one
scene with an arbitrary view sampler), the depth-sorted alpha compositing
that blends a render with overlay layers, and a dependency-free SVG
builder (figures embed base64 PNGs).

The compositing and the overlay layers run in torch on the layers' device;
the SVG builder, `to_uint8` and `encode_image` are numpy and PIL only.
"""

from __future__ import annotations

import base64
import dataclasses
from io import BytesIO
from pathlib import Path
from typing import Union

import numpy as np
import torch

MARGIN = 2


# ---------------------------------------------------------------------------
# Checkpoint / scene plumbing
# ---------------------------------------------------------------------------


def load_model(cfg, device: Union[str, torch.device] = "cuda"):
    """Build the encoder (on `device`) and decoder with the weights of
    `cfg.checkpointing.load`: a checkpoint of this package (`step_<n>`, or
    a directory of them) or a Lightning `.ckpt` (the reference's published
    format, through `interop/torch_import.py`). Returns (encoder, decoder)."""
    from ..model.decoder.decoder_splatting import DecoderSplatting
    from ..interop.torch_import import load_params
    from ..model.encoder.encoder_epipolar import EncoderEpipolar
    from ..training.model_wrapper import resolve_device
    from ..utils.wandb_tools import update_checkpoint_path

    if cfg.checkpointing.load is None:
        raise ValueError("figure scripts need checkpointing.load")
    ckpt = Path(update_checkpoint_path(cfg.checkpointing.load, cfg.wandb))
    encoder = EncoderEpipolar(cfg.model.encoder).to(resolve_device(device)).eval()
    load_params(ckpt, encoder)
    return encoder, DecoderSplatting(cfg.model.decoder)


def load_scene(
    dataset_cfg,
    scene: str,
    context_indices: list[int],
    target_indices: list[int],
    stage: str = "test",
) -> dict:
    """One batched example of `scene` at the given view indices (numpy
    arrays with a leading batch of 1, the scene name in a list), through
    the arbitrary view sampler and the dataset's shims."""
    from ..dataset import get_dataset
    from ..dataset.data_module import collate
    from ..dataset.view_sampler.view_sampler_arbitrary import ViewSamplerArbitraryCfg

    sampler = ViewSamplerArbitraryCfg(
        "arbitrary",
        len(context_indices),
        len(target_indices),
        context_views=list(context_indices),
        target_views=list(target_indices),
    )
    dataset_cfg = dataclasses.replace(dataset_cfg, view_sampler=sampler, overfit_to_scene=scene)
    dataset = get_dataset(dataset_cfg, stage, None, seed=0)
    return collate([next(iter(dataset))])


def load_metrics_config(overrides: list[str], evaluation: str):
    """compute_metrics-style config with a config/evaluation overlay
    (`evaluation` names a file of `config/evaluation/`, or is a path
    without the `.yaml`). Returns (root_cfg, evaluation_cfg)."""
    from ..config import CONFIG_ROOT, _convert, _deep_merge, _load_yaml, compose_config, load_typed_root_config
    from ..evaluation.evaluation_cfg import EvaluationCfg

    cfg_dict = compose_config(overrides, main_name="compute_metrics")
    data, _ = _load_yaml(CONFIG_ROOT / "evaluation" / f"{evaluation}.yaml")
    data.pop("defaults", None)
    cfg_dict = _deep_merge(cfg_dict, data)
    evaluation_cfg = _convert(cfg_dict.pop("evaluation", {}), EvaluationCfg)
    cfg_dict.pop("output_metrics_path", None)
    root = load_typed_root_config({k: v for k, v in cfg_dict.items() if k != "index_generator"})
    return root, evaluation_cfg


# ---------------------------------------------------------------------------
# Depth-sorted alpha compositing (render + overlay layers)
# ---------------------------------------------------------------------------


def composite_depth_layers(layers: list, canvas) -> torch.Tensor:
    """Alpha-composite (color, alpha, depth) layers, nearest-last wins, on
    the device of the first layer's colour.

    Every element is (3, h, w); alpha/depth are per channel. The sort is
    stable; layers of equal depth keep their order (only layers with no
    alpha at a pixel tie there: those of depth 1e10)."""
    first = layers[0][0]
    device = first.device if torch.is_tensor(first) else torch.device("cpu")

    def stack(i):
        return torch.stack([torch.as_tensor(layer[i], dtype=torch.float32, device=device) for layer in layers])

    colors, alphas, depths = stack(0), stack(1), stack(2)
    order = torch.sort(depths, dim=0, stable=True).indices
    colors = torch.take_along_dim(colors, order, dim=0)
    alphas = torch.take_along_dim(alphas, order, dim=0)
    t = torch.cumprod(1.0 - alphas, dim=0)
    t = torch.cat([torch.ones_like(t[:1]), t[:-1]], dim=0)
    image = (t * colors).sum(dim=0)
    total_alpha = (t * alphas).sum(dim=0)
    canvas = torch.as_tensor(canvas, dtype=torch.float32, device=device)
    return total_alpha * image + (1.0 - total_alpha) * canvas


def _nearest_point_values(
    shape: tuple[int, int],
    points: torch.Tensor,  # (n, 2) pixel coordinates (xy)
    values: torch.Tensor,  # (n,)
    radius: float,
    background: float,
) -> torch.Tensor:
    """`draw_points(full((3, h, w), background), points, values[:, None]
    repeated to 3, radius)`: every pixel takes its nearest disc's value (the
    first of equally near ones) at that disc's antialiased coverage. The
    per-pixel distances are taken a block of points at a time, so memory
    stays bounded at high resolution; the result is the same."""
    from ..visualization.drawing.rendering import coverage_from_distance, pixel_centres

    h, w = shape
    coords = pixel_centres(h, w, points.device)[:, :, None, :]  # (h, w, 1, 2)
    block = max(1, (1 << 26) // (h * w))
    nearest = index = None
    for start in range(0, points.shape[0], block):
        d = torch.linalg.vector_norm(coords - points[None, None, start : start + block], dim=-1) - radius
        i = torch.argmin(d, dim=-1)
        m = torch.gather(d, -1, i[..., None])[..., 0]
        if nearest is None:
            nearest, index = m, i
        else:
            closer = m < nearest  # an earlier block keeps ties
            nearest = torch.where(closer, m, nearest)
            index = torch.where(closer, i + start, index)
    alpha = coverage_from_distance(nearest)
    return background * (1 - alpha)[None] + values[index][None] * alpha[None]


def line_overlay_layers(
    lines: list[tuple[np.ndarray, np.ndarray]],
    view_extrinsics: np.ndarray,  # (4, 4) render camera
    view_intrinsics: np.ndarray,  # (3, 3) normalized
    image_shape: tuple[int, int],
    line_width: float,
    line_color=(0.0, 0.0, 0.0),
    point_density: float = 0.5,
    device: Union[str, torch.device] = "cpu",
) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(color, alpha, depth) compositing layers for 3D line segments, on
    `device`.

    One layer per segment: the alpha mask is an antialiased 2D line, the
    depth buffer a chain of projected points along the segment, which
    occludes the line against the Gaussian render."""
    from ..geometry.projection import project
    from ..visualization.drawing.lines import draw_lines

    h, w = image_shape
    scale = np.asarray([w, h], np.float32)
    w2c = np.linalg.inv(view_extrinsics)
    zeros = torch.zeros((3, h, w), dtype=torch.float32, device=device)
    color = torch.as_tensor(np.asarray(line_color, np.float32), device=device)
    extrinsics = torch.tensor(np.asarray(view_extrinsics, np.float32), device=device)
    intrinsics = torch.tensor(np.asarray(view_intrinsics, np.float32), device=device)

    def to_image(xyz: np.ndarray) -> np.ndarray:
        xy, _ = project(torch.tensor(xyz, device=device), extrinsics, intrinsics)
        return xy.cpu().numpy()

    layers = []
    for a, b in lines:
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        # Draw from the farther endpoint toward the nearer one.
        a_depth = (w2c @ np.append(a, 1.0))[2]
        b_depth = (w2c @ np.append(b, 1.0))[2]
        start, end = (a, b) if a_depth > b_depth else (b, a)
        start_2d, end_2d = to_image(start), to_image(end)

        alpha = draw_lines(zeros, (start_2d * scale)[None], (end_2d * scale)[None], (1.0, 1.0, 1.0), line_width)
        layer_color = color[:, None, None].expand(3, h, w) * (alpha > 0)

        # Depth along the segment via dense projected points.
        delta = float(np.linalg.norm((start_2d - end_2d) * scale))
        num_points = max(int(delta / point_density), 1)
        t = np.linspace(0.0, 1.0, num_points + 1, dtype=np.float32)
        xyz = start[None] * t[:, None] + end[None] * (1.0 - t)[:, None]
        depth_vals = np.linalg.norm(xyz - view_extrinsics[:3, 3], axis=-1)
        xy = to_image(xyz)
        depth = _nearest_point_values(
            (h, w),
            torch.as_tensor(xy * scale, device=device),
            torch.as_tensor(depth_vals, dtype=torch.float32, device=device),
            line_width,
            1e10,
        )
        layers.append((layer_color, alpha, depth.expand(3, h, w)))
    return layers


def frustum_lines(
    extrinsics: np.ndarray,  # (v, 4, 4)
    intrinsics: np.ndarray,  # (v, 3, 3)
    depth: np.ndarray,  # (v,)
    max_views: int | None = None,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """World-space camera-frustum wireframe segments (4 face edges + 4
    edges to the origin per view)."""
    from ..visualization.drawing.cameras import unproject_frustum_corners

    corners = unproject_frustum_corners(
        torch.as_tensor(np.asarray(extrinsics, np.float32)),
        torch.as_tensor(np.asarray(intrinsics, np.float32)),
        torch.as_tensor(np.asarray(depth, np.float32)),
    ).numpy()
    origins = extrinsics[:, :3, 3]
    lines = []
    for view, (view_corners, origin) in enumerate(zip(corners, origins)):
        if max_views is not None and view >= max_views:
            break
        for i in range(4):
            lines.append((view_corners[i], view_corners[i - 1]))
            lines.append((view_corners[i], origin))
    return lines


def to_uint8(image: np.ndarray) -> np.ndarray:
    """(3, h, w) float [0,1] -> (h, w, 3) uint8."""
    image = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
    return (image.transpose(1, 2, 0) * 255.0).round().astype(np.uint8)


def encode_image(image: np.ndarray, image_format: str = "png") -> str:
    """Encode a (3, h, w) float image as a data URI for SVG embedding."""
    from PIL import Image

    stream = BytesIO()
    Image.fromarray(to_uint8(image)).save(stream, image_format)
    data = base64.b64encode(stream.getvalue()).decode("ascii")
    return f"data:image/{image_format};base64,{data}"


class SvgFigure:
    """Minimal SVG document builder (images, lines, circles, text)."""

    def __init__(self, width: float, height: float):
        self.width = width
        self.height = height
        self._elements: list[str] = []

    def add_image(self, image: np.ndarray, x: float, y: float, w: float, h: float):
        uri = encode_image(image)
        self._elements.append(
            f'<image x="{x}" y="{y}" width="{w}" height="{h}" '
            f'xlink:href="{uri}"/>'
        )

    def add_line(self, x1, y1, x2, y2, color="#000", width=1.0):
        self._elements.append(
            f'<line x1="{x1}" y1="{y1}" x2="{x2}" y2="{y2}" '
            f'stroke="{color}" stroke-width="{width}"/>'
        )

    def add_circle(self, cx, cy, r, color="#000", fill="none"):
        self._elements.append(
            f'<circle cx="{cx}" cy="{cy}" r="{r}" stroke="{color}" fill="{fill}"/>'
        )

    def add_text(
        self, text, x=None, y=None, size=10, color="#000", anchor="start",
        transform=None,
    ):
        pos = ""
        if x is not None:
            pos = f'x="{x}" y="{y}" '
        tf = f'transform="{transform}" ' if transform else ""
        self._elements.append(
            f'<text {pos}{tf}font-size="{size}" fill="{color}" '
            f'text-anchor="{anchor}" font-family="sans-serif">{text}</text>'
        )

    def add_rect(
        self, width, height, x=None, y=None, fill="#fff", rx=0.0,
        transform=None,
    ):
        pos = ""
        if x is not None:
            pos = f'x="{x}" y="{y}" '
        tf = f'transform="{transform}" ' if transform else ""
        self._elements.append(
            f'<rect {pos}{tf}width="{width}" height="{height}" '
            f'rx="{rx}" ry="{rx}" fill="{fill}"/>'
        )

    def save(self, path: Path | str) -> None:
        body = "\n".join(self._elements)
        doc = (
            '<svg xmlns="http://www.w3.org/2000/svg" '
            'xmlns:xlink="http://www.w3.org/1999/xlink" '
            f'width="{self.width}" height="{self.height}" '
            f'viewBox="0 0 {self.width} {self.height}">\n{body}\n</svg>\n'
        )
        Path(path).write_text(doc)
