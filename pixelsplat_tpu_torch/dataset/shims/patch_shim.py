"""Patch shim: centre-crop batched images to a multiple of the patch size.

Port of `pixelsplat_tpu/dataset/shims/patch_shim.py`.
"""

from __future__ import annotations


def apply_patch_shim_to_views(views: dict, patch_size: int) -> dict:
    *_, h, w = views["image"].shape
    if h % 2 or w % 2:
        raise ValueError(f"image size {h}x{w} must be even")
    h_new = (h // patch_size) * patch_size
    row = (h - h_new) // 2
    w_new = (w // patch_size) * patch_size
    col = (w - w_new) // 2
    image = views["image"][..., row : row + h_new, col : col + w_new]
    # Normalized intrinsics: fx *= w / w_new, fy *= h / h_new.
    intrinsics = views["intrinsics"].clone()
    intrinsics[..., 0, 0] *= w / w_new
    intrinsics[..., 1, 1] *= h / h_new
    return {**views, "image": image, "intrinsics": intrinsics}


def apply_patch_shim(batch: dict, patch_size: int) -> dict:
    return {
        **batch,
        "context": apply_patch_shim_to_views(batch["context"], patch_size),
        "target": apply_patch_shim_to_views(batch["target"], patch_size),
    }
