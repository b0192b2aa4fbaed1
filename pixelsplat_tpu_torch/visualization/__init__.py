"""Port of `pixelsplat_tpu/visualization` (the validation grid's layout and labels)."""
