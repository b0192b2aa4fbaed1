"""Small constants that the encoder builds on the host and keeps on the device.

Each constant depends only on shapes: a resize matrix, the view-pair index,
the positional encoding's phases, the pixel size, the SH mask and the SH
rotation's fixed directions. Copying one from pageable host memory waits for
the device's queue to drain, and cannot be captured into a CUDA graph. So
each is copied once per (name, arguments, dtype, device), inside the sync
point `upload.<name>`, and every later call gets the same device tensor.
The values are those of the host construction, cast as `torch.as_tensor`
casts them. Callers must not write to what they get.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from . import tracing

_cache: dict = {}


def on_device(name: str, build: Callable[..., Any], *args, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`torch.as_tensor(build(*args), dtype=dtype, device=device)`, made on
    the first call for these `name`, `args`, `dtype` and `device` and kept.
    `args` must be hashable and, with `name`, say everything `build` reads."""
    device = torch.device(device)
    key = (name, args, dtype, device)
    found = _cache.get(key)
    if found is None:
        # A tensor made under inference mode could not be saved for a
        # backward pass later.
        with tracing.sync_point(f"upload.{name}"), torch.inference_mode(False):
            found = torch.as_tensor(build(*args), dtype=dtype, device=device)
        _cache[key] = found
    return found
