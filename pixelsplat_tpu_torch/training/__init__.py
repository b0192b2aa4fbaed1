"""Port of `pixelsplat_tpu/training`."""
