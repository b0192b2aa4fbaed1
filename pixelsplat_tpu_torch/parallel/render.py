"""View-parallel rendering across the ranks of a process group.

Port of `pixelsplat_tpu/parallel/render.py`: the target views of a
decoding pass are split over the ranks, every rank holding the whole
scene, and the rendered views are gathered back on every rank.

The gather is an all-reduce: each rank writes its own views into a
zero-filled buffer of all the views and the buffers are summed. Every
element is one rank's value plus zeros, so the sum is exact, and the
all-reduce is the one collective that gloo offers on CUDA tensors beside
broadcast (it has no all-gather there), so the same code runs under NCCL
and gloo.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

from ..model.decoder.decoder_splatting import DecoderOutput, DecoderSplatting
from ..model.types import Gaussians
from ..ops.rasterizer.projection import GaussiansSoA
from ..ops.rasterizer.render import RenderSettings
from .mesh import all_reduce_sum_, world_size


def render_views_sharded(
    decoder: DecoderSplatting,
    gaussians: Union[Gaussians, GaussiansSoA],
    extrinsics: torch.Tensor,  # (b, v, 4, 4)
    intrinsics: torch.Tensor,  # (b, v, 3, 3)
    near: torch.Tensor,  # (b, v)
    far: torch.Tensor,  # (b, v)
    image_shape: tuple[int, int],
    depth_mode: Optional[str] = None,
    group: Optional[dist.ProcessGroup] = None,
    render_settings: Optional[RenderSettings] = None,
) -> DecoderOutput:
    """Render the (b, v) target views with v split over the group's ranks.

    v is padded to a multiple of the world size by repeating the last
    camera; rank r renders views [r s, (r + 1) s) of the padded axis, s =
    v_pad / world, and the padded views are dropped after the gather. The
    Gaussians and cameras must be the same on every rank. `overflow` counts
    the pairs dropped in the real views only. Without a group it is the
    decoder's own call.
    """
    world = world_size(group)
    if world == 1:
        return decoder(gaussians, extrinsics, intrinsics, near, far, image_shape,
                       depth_mode=depth_mode, render_settings=render_settings)
    rank = dist.get_rank(group)
    b, v = near.shape
    v_pad = -(-v // world) * world
    share = v_pad // world
    lo, hi = rank * share, (rank + 1) * share

    def views(x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
        # Padded positions take the last real camera.
        index = torch.arange(start, stop, device=x.device).clamp(max=v - 1)
        return x.index_select(1, index)

    def render(start: int, stop: int) -> DecoderOutput:
        return decoder(
            gaussians, views(extrinsics, start, stop), views(intrinsics, start, stop), views(near, start, stop),
            views(far, start, stop), image_shape, depth_mode=depth_mode, render_settings=render_settings,
        )

    h, w = image_shape
    outputs = [render(lo, min(hi, v))] if lo < v else []
    if hi > v:  # padded views: rendered as their rank's share, not counted
        outputs.append(render(max(lo, v), hi))
    color = torch.cat([o.color for o in outputs], dim=1)
    colors = color.new_zeros((b, v_pad, *color.shape[2:]))
    colors[:, lo:hi] = color
    gathered = [colors]
    if depth_mode is not None:
        depths = color.new_zeros((b, v_pad, h, w))
        depths[:, lo:hi] = torch.cat([o.depth for o in outputs], dim=1)
        gathered.append(depths)
    # In f32 beside the images, one collective for all: exact to 2^24 pairs.
    overflow = color.new_zeros(())
    if lo < v:
        overflow += outputs[0].overflow.to(color.dtype)
    all_reduce_sum_(gathered + [overflow], group)
    return DecoderOutput(
        color=colors[:, :v],
        depth=None if depth_mode is None else gathered[1][:, :v],
        overflow=overflow.to(torch.int32),
    )
