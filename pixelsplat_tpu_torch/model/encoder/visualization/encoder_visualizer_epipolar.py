"""Encoder figures: epipolar samples, attention, depth pdf, depth, Gaussians.

Port of `pixelsplat_tpu/model/encoder/visualization/encoder_visualizer_epipolar.py`,
the full figure set of its `visualize`: epipolar samples and colour
samples, the context overlaps, the epipolar attention per layer and head,
the depth-bucket probabilities, per-surface depth and disparity, the
Gaussian panels and the Gaussian scale / rotation histograms.

The encoder runs probabilistically (`deterministic=False`), its uniforms
drawn from the caller's `torch.Generator` or given as `u`, inside
`EncoderEpipolar.capture_intermediates`, which records what the JAX encoder
sows: the epipolar transformer's cross-attention maps and the depth
predictor's pdf. The figures are drawn on the context's device with the
drawing primitives and laid out in numpy.

The histograms of `gaussian_stats` are computed with numpy on any machine;
the figure is drawn with matplotlib, imported when it is drawn. Where
matplotlib does not import, the figure is left out and `omitted` names it
with the reason (the JAX function raises there, and the JAX trainer's
blanket `except` then loses every figure).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ....utils.pairings import generate_heterogeneous_index
from ....visualization.annotation import add_label
from ....visualization.color_map import apply_color_map, apply_color_map_to_image
from ....visualization.colors import get_distinct_color
from ....visualization.drawing.lines import draw_lines
from ....visualization.drawing.points import draw_points
from ....visualization.layout import add_border, hcat, vcat
from ..epipolar.epipolar_sampler import EpipolarSampling, sample_along_epipolar_lines

# The figure keys of a full `visualize`, in order.
FIGURES = (
    "epipolar_samples", "epipolar_color_samples", "overlaps", "attention", "probabilities", "depth",
    "gaussians", "gaussian_stats",
)
HISTOGRAM_BINS = 64
# The rays whose epipolar samples the figures draw.
NUM_RAYS = 8


def host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def gaussian_histograms(scales: torch.Tensor, rotations: torch.Tensor) -> dict:
    """numpy histograms (counts, edges) of batch element 0's log10 Gaussian
    scales and rotation angles in degrees, 64 bins each, as matplotlib's
    `hist` bins them."""
    scales = host(scales[0].float()).reshape(-1)
    rotations = host(rotations[0].float()).reshape(-1, 4)
    # The rotation angle from the quaternion's scalar (last) component.
    wq = np.clip(np.abs(rotations[:, -1]) / (np.linalg.norm(rotations, axis=-1) + 1e-9), 0, 1)
    angles = 2.0 * np.degrees(np.arccos(wq))
    return {
        "log10_scale": np.histogram(np.log10(np.maximum(scales, 1e-9)), bins=HISTOGRAM_BINS),
        "rotation_angle": np.histogram(angles, bins=HISTOGRAM_BINS),
    }


class EncoderVisualizerEpipolar:
    def __init__(self, encoder):
        self.encoder = encoder
        # What the last `visualize` left out, and why; its histograms.
        self.omitted: dict[str, str] = {}
        self.histograms: dict = {}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def visualize(
        self,
        context: dict,
        global_step: int,
        generator: Optional[torch.Generator] = None,
        u: Optional[torch.Tensor] = None,
    ) -> dict[str, np.ndarray]:
        """Encode `context` probabilistically with the intermediates
        captured, and draw the figures: {key: (3, h, w) float image}."""
        self.omitted, self.histograms = {}, {}
        if not self.encoder.cfg.use_epipolar_transformer:
            return {}
        dump: dict = {}
        with self.encoder.capture_intermediates() as captured:
            gaussians = self.encoder(context, global_step, False, u=u, generator=generator, visualization_dump=dump)

        out: dict[str, np.ndarray] = {}
        if "sampling" in dump:
            sampling = dump["sampling"]
            out["epipolar_samples"] = self._visualize_epipolar_samples(context, sampling)
            out["epipolar_color_samples"] = self._visualize_epipolar_color_samples(context)
            out["overlaps"] = self._visualize_overlaps(context, sampling)
            attention = self._collect_attention(captured)
            if attention is not None:
                out["attention"] = self._visualize_attention(context, sampling, attention)
            if "pdf" in captured:
                out["probabilities"] = self._visualize_probabilities(context, sampling, captured["pdf"])
        if "depth" in dump:
            out["depth"] = self._visualize_depth(context, dump["depth"])
        out["gaussians"] = self._visualize_gaussians(context, gaussians)
        if "scales" in dump and "rotations" in dump:
            self.histograms = gaussian_histograms(dump["scales"], dump["rotations"])
            try:
                import matplotlib  # noqa: F401
            except ImportError as exc:
                self.omitted["gaussian_stats"] = f"matplotlib does not import ({exc})"
            else:
                out["gaussian_stats"] = self._visualize_gaussian_stats(self.histograms)
        return out

    # ------------------------------------------------------------------
    def _pick_rays(self, num_rays: int) -> np.ndarray:
        rng = np.random.default_rng(0)
        return rng.choice(num_rays, size=min(NUM_RAYS, num_rays), replace=False)

    def _ray_view(self, image: torch.Tensor, xy_ray: np.ndarray, w, h) -> np.ndarray:
        colors = np.asarray([get_distinct_color(i) for i in range(len(xy_ray))], np.float32)
        view = draw_points(image, xy_ray * [w, h], 0.0, 4.0)
        return host(draw_points(view, xy_ray * [w, h], colors, 3.0))

    def _visualize_epipolar_samples(self, context: dict, sampling: EpipolarSampling) -> np.ndarray:
        """The ray view, and the sample view: each picked ray's epipolar
        line in black, its buckets in alternating segments, its samples as
        points in the ray's colour."""
        images = context["image"][0]  # (v, 3, h, w)
        v, _, h, w = images.shape
        _, index_other = generate_heterogeneous_index(v)
        rv, rov = 0, 0
        picks = self._pick_rays(sampling.xy_sample.shape[3])
        s = sampling.xy_sample.shape[4]

        xy_ray = host(sampling.xy_ray[0, rv])[picks]
        ray_view = self._ray_view(images[rv], xy_ray, w, h)

        near = host(sampling.xy_sample_near[0, rv, rov])[picks]  # (r, s, 2)
        far = host(sampling.xy_sample_far[0, rv, rov])[picks]
        other = images[index_other[rv, rov]]
        # The whole epipolar line in black, then alternating bucket segments.
        sample_view = draw_lines(other, near[:, 0] * [w, h], far[:, -1] * [w, h], 0.0, 5.0, cap="butt")
        alt = np.tile(np.asarray([0.0, 1.0])[None, :, None], (len(picks), (s + 1) // 2, 3))[:, :s].reshape(-1, 3)
        sample_view = draw_lines(sample_view, near.reshape(-1, 2) * [w, h], far.reshape(-1, 2) * [w, h], alt, 3.0,
                                 cap="butt")
        pts = host(sampling.xy_sample[0, rv, rov])[picks].reshape(-1, 2)
        pt_colors = np.asarray([get_distinct_color(i // s) for i in range(s * len(picks))], np.float32)
        sample_view = draw_points(sample_view, pts * [w, h], 0.0, 4.0)
        sample_view = draw_points(sample_view, pts * [w, h], pt_colors, 3.0)

        return add_border(hcat(add_label(ray_view, "Ray View"), add_label(host(sample_view), "Sample View")))

    def _visualize_epipolar_color_samples(self, context: dict) -> np.ndarray:
        """The raw image's colours sampled along the picked rays' epipolar
        lines, ringed in each ray's colour."""
        images = context["image"]  # (b, v, 3, h, w)
        b, v, _, h, w = images.shape
        sampling = sample_along_epipolar_lines(
            images.permute(0, 1, 3, 4, 2), context["extrinsics"], context["intrinsics"], context["near"],
            context["far"], self.encoder.cfg.epipolar_transformer.num_samples,
        )
        _, index_other = generate_heterogeneous_index(v)
        rv, rov = 0, 0
        picks = self._pick_rays(sampling.xy_sample.shape[3])
        s = sampling.xy_sample.shape[4]
        imgs = images[0]

        xy_ray = host(sampling.xy_ray[0, rv])[picks]
        ray_view = self._ray_view(imgs[rv], xy_ray, w, h)

        pts = host(sampling.xy_sample[0, rv, rov])[picks].reshape(-1, 2)
        ring = np.asarray([get_distinct_color(i // s) for i in range(s * len(picks))], np.float32)
        fill = host(sampling.features[0, rv, rov].float())[picks].reshape(-1, 3)
        sample_view = draw_points(imgs[index_other[rv, rov]], pts * [w, h], ring, 4.0)
        sample_view = draw_points(sample_view, pts * [w, h], fill, 3.0)

        return add_border(hcat(add_label(ray_view, "Ray View"), add_label(host(sample_view), "Sample View")))

    def _visualize_overlaps(self, context: dict, sampling: EpipolarSampling) -> np.ndarray:
        """Green-tinted masks of the rays whose epipolar line meets each
        other view."""
        images = host(context["image"][0])  # (v, 3, h, w)
        v, _, h, w = images.shape
        ds = self.encoder.cfg.epipolar_transformer.downscale or 1
        hd, wd = h // ds, w // ds
        green = np.asarray([0.235, 0.706, 0.294], np.float32)[:, None, None]
        _, index_other = generate_heterogeneous_index(v)
        valid_all = host(sampling.valid[0]).astype(np.float32)

        rows = []
        for view in range(v):
            valid = valid_all[view].reshape(-1, hd, wd)  # (ov, hd, wd)
            tiles = []
            for ov in range(valid.shape[0]):
                mask = np.repeat(np.repeat(valid[ov], ds, 0), ds, 1)[None]
                tiles.append(mask * (green + images[index_other[view, ov]]) / 2)
            rows.append(hcat(images[view], *tiles))
        return add_border(add_label(vcat(*rows), "Context Overlaps"))

    def _visualize_gaussians(self, context: dict, gaussians) -> np.ndarray:
        """Opacity, colour, raw colour and covariance determinant panels,
        one row per Gaussian of a pixel (surface 0)."""
        images = host(context["image"][0])  # (v, 3, h, w)
        v, _, h, w = images.shape
        gpp = self.encoder.cfg.gaussians_per_pixel
        srf = self.encoder.cfg.num_surfaces

        def to_maps(x: np.ndarray, ch: int) -> np.ndarray:
            # (v * h * w * srf * gpp, ...) -> (gpp, v, ch, h, w); surface 0.
            arr = np.asarray(x, np.float32).reshape(v, h, w, srf, gpp, ch)
            return arr[:, :, :, 0].transpose(3, 0, 4, 1, 2)

        opacity = np.repeat(to_maps(host(gaussians.opacities[0, :, None]), 1), 3, axis=2)
        colors = np.clip(to_maps(host(gaussians.harmonics[0, :, :, 0]), 3) + 0.5, 0, 1)
        det = np.linalg.det(host(gaussians.covariances[0]).astype(np.float64))
        det = apply_color_map((det / max(det.max(), 1e-30)).astype(np.float32), "inferno")
        det = to_maps(det, 3)

        def grid(maps):
            return vcat(*[hcat(*row) for row in maps])

        return add_border(
            hcat(
                add_label(hcat(*images), "Context"),
                add_label(grid(opacity), "Opacities"),
                add_label(grid(colors * opacity), "Colors"),
                add_label(grid(colors), "Colors (Raw)"),
                add_label(grid(det), "Determinant"),
            )
        )

    def _visualize_depth(self, context: dict, depth: torch.Tensor) -> np.ndarray:
        """Per surface: relative depth and relative disparity in turbo."""
        d_all = host(depth[0])  # (v, h, w, srf, spp)
        near = host(context["near"][0].float())[:, None, None]
        far = host(context["far"][0].float())[:, None, None]
        panels = []
        for i in range(d_all.shape[3]):
            d = d_all[:, :, :, i].mean(axis=-1)  # (v, h, w)
            rel_depth = np.clip((d - near) / (far - near), 0, 1)
            rel_disp = np.clip(1 - (1 / d - 1 / far) / (1 / near - 1 / far), 0, 1)
            rel_depth = apply_color_map_to_image(rel_depth, "turbo")
            rel_disp = apply_color_map_to_image(rel_disp, "turbo")
            panels.append(
                add_border(hcat(add_label(hcat(*rel_depth), "Depth"), add_label(hcat(*rel_disp), "Disparity")))
            )
        return add_border(vcat(*panels))

    def _visualize_attention(self, context: dict, sampling: EpipolarSampling, attention: np.ndarray) -> np.ndarray:
        """Per layer and head, each picked ray's epipolar segments in its
        colour weighted by the attention on them."""
        images = context["image"][0]
        v, _, h, w = images.shape
        b = context["image"].shape[0]
        _, index_other = generate_heterogeneous_index(v)
        rv, rov = 0, 0
        r = sampling.xy_sample.shape[3]
        s = sampling.xy_sample.shape[4]
        picks = self._pick_rays(r)

        # attention: (layer, b*v*r, head, 1, s*ov) -> per ray, head, sample.
        layers = []
        base_colors = np.asarray([get_distinct_color(i) for i in range(len(picks))], np.float32)
        near = host(sampling.xy_sample_near[0, rv, rov])[picks].reshape(-1, 2)
        far = host(sampling.xy_sample_far[0, rv, rov])[picks].reshape(-1, 2)
        other = images[index_other[rv, rov]]
        num_layers = attention.shape[0]
        num_heads = attention.shape[2]
        ov_total = sampling.xy_sample.shape[2]
        for il in range(num_layers):
            attn = attention[il].reshape(b, v, r, num_heads, s, ov_total)[0, rv, picks, :, :, rov]  # (picks, hd, s)
            heads = []
            for ihd in range(num_heads):
                weight = attn[:, ihd, :, None]  # (picks, s, 1)
                col = (weight * base_colors[:, None]).reshape(-1, 3)
                heads.append(host(draw_lines(other, near * [w, h], far * [w, h], col, 3.0, cap="butt")))
            layers.append(add_label(vcat(*heads), f"Layer {il}"))
        ray_view = self._ray_view(images[rv], host(sampling.xy_ray[0, rv])[picks], w, h)
        vis = add_label(add_border(hcat(*layers)), "Keys & Values")
        return add_border(hcat(add_label(ray_view, "Rays"), vis))

    def _visualize_probabilities(self, context: dict, sampling: EpipolarSampling, pdf: torch.Tensor) -> np.ndarray:
        """Each picked ray's depth-bucket pdf drawn along its epipolar
        segments, raw and magnified per ray."""
        images = context["image"][0]  # (v, 3, h, w)
        v, _, h, w = images.shape
        _, index_other = generate_heterogeneous_index(v)
        rv, rov = 0, 0
        picks = self._pick_rays(sampling.xy_sample.shape[3])
        colors = np.asarray([get_distinct_color(i) for i in range(len(picks))], np.float32)

        xy_ray = host(sampling.xy_ray[0, rv])[picks]  # (k, 2)
        ray_view = self._ray_view(images[rv], xy_ray, w, h)

        # pdf: (b, v, full-res rays, srf, buckets); the epipolar sampling
        # grid is downscaled, so each coarse ray reads the pdf at its nearest
        # full-resolution pixel (surface 0).
        p_full = host(pdf[0, rv, :, 0, :].float()).reshape(h, w, -1)
        ix = np.clip((xy_ray[:, 0] * w).astype(int), 0, w - 1)
        iy = np.clip((xy_ray[:, 1] * h).astype(int), 0, h - 1)
        p = p_full[iy, ix]  # (k, buckets)

        # Depth buckets and epipolar samples are both evenly spaced in
        # relative disparity; resampled if the counts differ.
        s = sampling.xy_sample.shape[4]
        if p.shape[-1] != s:
            grid_b = (np.arange(p.shape[-1]) + 0.5) / p.shape[-1]
            grid_s = (np.arange(s) + 0.5) / s
            p = np.stack([np.interp(grid_s, grid_b, row) for row in p])

        near = host(sampling.xy_sample_near[0, rv, rov])[picks].reshape(-1, 2)
        far = host(sampling.xy_sample_far[0, rv, rov])[picks].reshape(-1, 2)
        other = images[index_other[rv, rov]]

        col = (p[:, :, None] * colors[:, None, :]).reshape(-1, 3)
        sample_view = draw_lines(other, near * [w, h], far * [w, h], col, 6.0, cap="butt")
        p_mag = p / np.maximum(p.max(axis=-1, keepdims=True), 1e-9)
        col_mag = (p_mag[:, :, None] * colors[:, None, :]).reshape(-1, 3)
        sample_view_mag = draw_lines(other, near * [w, h], far * [w, h], col_mag, 6.0, cap="butt")

        return add_border(
            hcat(
                add_label(ray_view, "Rays"),
                add_label(host(sample_view), "Samples"),
                add_label(host(sample_view_mag), "Samples (Magnified PDF)"),
            )
        )

    def _visualize_gaussian_stats(self, histograms: dict) -> np.ndarray:
        """The two histograms drawn with matplotlib (Agg), as the JAX
        visualizer's `hist` draws them."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(8, 3), dpi=100)
        for ax, key, title in zip(axes, ("log10_scale", "rotation_angle"),
                                  ("log10 Gaussian scales", "rotation angle (deg)")):
            counts, edges = histograms[key]
            ax.hist(edges[:-1], bins=edges, weights=counts)
            ax.set_title(title)
        fig.tight_layout()
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        plt.close(fig)
        return img.transpose(2, 0, 1).astype(np.float32) / 255.0

    def _collect_attention(self, captured: dict) -> Optional[np.ndarray]:
        """The cross-attention maps of each layer stacked as (layer, tokens,
        head, q, k), in the JAX visualizer's order: its sown paths
        ("transformer/attn_<i>/attention") sorted as strings."""
        maps = captured["attention"]
        if not maps or not all(maps):
            return None
        order = sorted(range(len(maps)), key=lambda i: f"attn_{i}")
        return np.stack([host(maps[i][0].float()) for i in order])
