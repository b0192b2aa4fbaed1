"""Tiled Gaussian-splatting rasterizer (port of `pixelsplat_tpu/ops/rasterizer`)."""

from .binning import TileLists, bin_gaussians, tile_occupancy
from .composite import composite_tiles, pack_columns
from .composite_kernel import composite_core, composite_core_plain
from .projection import GaussiansSoA, ProjectedGaussians, project_gaussians, project_gaussians_soa
from .render import (
    DEFAULT_SETTINGS,
    DepthRenderingMode,
    RenderSettings,
    orthographic_frustum,
    render,
    render_depth,
    render_orthographic,
    render_view_soa,
)

__all__ = [
    "TileLists",
    "bin_gaussians",
    "tile_occupancy",
    "composite_tiles",
    "pack_columns",
    "composite_core",
    "composite_core_plain",
    "GaussiansSoA",
    "ProjectedGaussians",
    "project_gaussians",
    "project_gaussians_soa",
    "DEFAULT_SETTINGS",
    "DepthRenderingMode",
    "RenderSettings",
    "orthographic_frustum",
    "render",
    "render_depth",
    "render_orthographic",
    "render_view_soa",
]
