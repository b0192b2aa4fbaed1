"""Nested dict-of-tensor tree merging.

Port of `pixelsplat_tpu/utils/collation.py`.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

Tree = Union[dict, torch.Tensor]


def collate(trees: list[Tree], merge_fn: Callable = torch.stack) -> Tree:
    """Merge a list of nested dict trees leaf-wise with merge_fn."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: collate([t[k] for t in trees], merge_fn) for k in first}
    return merge_fn(trees)
