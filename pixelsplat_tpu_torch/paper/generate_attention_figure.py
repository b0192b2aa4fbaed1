"""Epipolar attention figure: query points + attention-coloured sample lines.

Port of `pixelsplat_tpu/paper/generate_attention_figure.py`: loads a
checkpoint, encodes the figure scene deterministically while capturing the
epipolar transformer's cross-attention maps
(`EncoderEpipolar.capture_intermediates`), then writes an SVG with the two
context views side by side: coloured query points in the left view and,
for each query, its epipolar segment in the right view drawn sample by
sample, the chosen layer and head's attention weight scaling the query's
colour. No compositing kernel runs.

Usage:
  python -m pixelsplat_tpu_torch.paper.generate_attention_figure \\
      +experiment=re10k checkpointing.load=<ckpt> \\
      [--output attention.svg] [--scene name:c0:c1] \\
      [--layer 1] [--head 2] [--query x,y ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..config import load_config
from ..visualization.colors import get_distinct_color
from .common import MARGIN, SvgFigure, load_model, load_scene
from .generate_point_cloud_figure import encode_scene

# The published figure scene and query pixels.
SCENE = ("2177ca3a775a9ee9", 135, 195)
QUERIES = (
    (238, 168),  # sofa pillow corner
    (238, 80),  # painting corner
    (159, 195),  # plant leaves
    (227, 277),  # carpet corner
    (300, 80),  # random spot on wall
)
QUERIES = tuple((x / 400.0, y / 400.0) for x, y in QUERIES)
LAYER = 1
HEAD = 2
FIGURE_WIDTH = 240
LINE_WIDTH = 4.0
RAY_RADIUS = 2.0
RAY_BACKER_RADIUS = 2.5


def _to_hex(color: np.ndarray) -> str:
    r, g, b = (int(np.clip(c, 0.0, 1.0) * 255) for c in np.asarray(color))
    return f"#{r:02x}{g:02x}{b:02x}"


def stack_cross_attention(captured: dict) -> np.ndarray:
    """The captured cross-attention maps stacked as (layer, tokens, head,
    1, samples * (v - 1)), in the order of the JAX package's stack: its
    sown paths ("transformer/attn_<i>/attention") sorted as strings."""
    maps = captured["attention"]
    order = sorted(range(len(maps)), key=lambda i: f"attn_{i}")
    return np.stack([maps[i][0].float().cpu().numpy() for i in order])


def generate_attention_figure(
    encoder, example: dict, queries, layer: int, head: int, downscale: int, out: Path
) -> np.ndarray:
    """Write the SVG; returns the stacked attention maps."""
    device = next(encoder.parameters()).device
    _, dump, captured = encode_scene(encoder, example, device)
    attention = stack_cross_attention(captured)
    sampling = dump["sampling"]

    context_images = np.asarray(example["context"]["image"])
    b, v, _, h, w = context_images.shape
    hd, wd = h // downscale, w // downscale

    # Queries to token indices at the transformer's (downscaled) resolution.
    wh = np.asarray([wd, hd], np.float32)
    cols_rows = (np.asarray(queries, np.float32) * wh).astype(np.int64)
    token_rows = cols_rows[:, 1] * wd + cols_rows[:, 0]

    rb, rv, rov = 0, 0, 0
    _, _, _, r, s, _ = sampling.xy_sample.shape
    num_layers = attention.shape[0]
    # (l, b*v*r, hd, 1, s*ov) -> (l, r, hd, s) for the chosen batch/view.
    maps = attention.reshape(num_layers, b, v, r, attention.shape[2], -1)
    maps = maps[:, rb, rv, token_rows]  # (l, queries, hd, s*ov)
    attn = maps[layer, :, head, :]  # (queries, s*ov)
    attn = attn[:, rov * s : (rov + 1) * s]
    attn = attn / np.maximum(attn.max(axis=-1, keepdims=True), 1e-12)

    colors = np.asarray([get_distinct_color(i) for i in range(len(token_rows))])

    left_image = context_images[rb, rv]
    # With v=2 the only other view is 1 - rv.
    right_image = context_images[rb, (rv + 1 + rov) % v]

    image_width = (FIGURE_WIDTH - MARGIN) / 2
    image_height = image_width * h / w
    fig = SvgFigure(FIGURE_WIDTH, image_height)
    fig.add_image(left_image, 0, 0, image_width, image_height)
    fig.add_image(right_image, image_width + MARGIN, 0, image_width, image_height)

    scale = np.asarray([image_width, image_height], np.float32)
    xy_ray = sampling.xy_ray.cpu().numpy()
    xy_near = sampling.xy_sample_near.cpu().numpy()
    xy_far = sampling.xy_sample_far.cpu().numpy()

    for q_idx, token in enumerate(token_rows):
        # The full epipolar segment: a black backer line (clipped by the
        # viewBox) behind the per-sample attention-coloured segments.
        start = xy_near[rb, rv, rov, token, 0] * scale
        end = xy_far[rb, rv, rov, token, -1] * scale
        start = start + [image_width + MARGIN, 0]
        end = end + [image_width + MARGIN, 0]
        fig.add_line(2 * start[0] - end[0], 2 * start[1] - end[1], end[0], end[1], color="#000000", width=LINE_WIDTH)
        for sv in range(s):
            seg_a = xy_near[rb, rv, rov, token, sv] * scale
            seg_b = xy_far[rb, rv, rov, token, sv] * scale
            fig.add_line(
                seg_a[0] + image_width + MARGIN,
                seg_a[1],
                seg_b[0] + image_width + MARGIN,
                seg_b[1],
                color=_to_hex(colors[q_idx] * attn[q_idx, sv]),
                width=LINE_WIDTH,
            )

    # Query points last so they sit on top (backer ring + coloured dot).
    for q_idx, token in enumerate(token_rows):
        ray_xy = xy_ray[rb, rv, token] * scale
        fig.add_circle(ray_xy[0], ray_xy[1], RAY_BACKER_RADIUS, color="none", fill="#000000")
        fig.add_circle(ray_xy[0], ray_xy[1], RAY_RADIUS, color="none", fill=_to_hex(colors[q_idx]))

    out.parent.mkdir(parents=True, exist_ok=True)
    fig.save(out)
    print(f"Wrote {out}")
    return attention


def main(argv: list[str]) -> np.ndarray:
    """Write the figure; returns the stacked attention maps."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--output", type=Path, default=Path("attention.svg"))
    parser.add_argument("--scene", default=None, metavar="name:c0:c1")
    parser.add_argument("--layer", type=int, default=LAYER)
    parser.add_argument("--head", type=int, default=HEAD)
    parser.add_argument(
        "--query",
        action="append",
        default=None,
        metavar="x,y",
        help="normalized query positions (repeatable; default: published set)",
    )
    parser.add_argument("--device", default="cuda")
    args, overrides = parser.parse_known_args(argv)

    cfg = load_config(["+experiment=re10k", "mode=test", *overrides])
    encoder, _ = load_model(cfg, args.device)
    if args.scene:
        scene, c0, c1 = args.scene.split(":")
        scene_spec = (scene, int(c0), int(c1))
    else:
        scene_spec = SCENE
    queries = [tuple(float(t) for t in q.split(",")) for q in args.query] if args.query else list(QUERIES)

    scene, c0, c1 = scene_spec
    example = load_scene(cfg.dataset, scene, [c0, c1], [c0, c1])
    return generate_attention_figure(
        encoder, example, queries, args.layer, args.head, cfg.model.encoder.epipolar_transformer.downscale, args.output
    )


if __name__ == "__main__":
    main(sys.argv[1:])
