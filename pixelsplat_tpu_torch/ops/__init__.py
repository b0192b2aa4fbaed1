"""Port of `pixelsplat_tpu/ops`."""
