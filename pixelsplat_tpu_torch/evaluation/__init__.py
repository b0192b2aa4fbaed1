"""Port of `pixelsplat_tpu/evaluation`."""
