"""Port of `pixelsplat_tpu/utils`."""
