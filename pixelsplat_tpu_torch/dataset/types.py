"""Batch schema types.

Port of `pixelsplat_tpu/dataset/types.py`. Batches are plain dicts of
numpy arrays on the host (tensors once on the device):

views = {
    "extrinsics": (v, 4, 4) or batched (b, v, 4, 4),
    "intrinsics": (v, 3, 3),
    "image": (v, 3, h, w) float in [0, 1],
    "near": (v,),
    "far": (v,),
    "index": (v,),
}
example = {"context": views, "target": views, "scene": str}
"""

from __future__ import annotations

from typing import Callable, Literal

Stage = Literal["train", "val", "test"]

AnyViews = dict
AnyExample = dict
BatchedViews = dict
BatchedExample = dict

# A data shim modifies a batched example (on the host or the device).
DataShim = Callable[[BatchedExample], BatchedExample]
