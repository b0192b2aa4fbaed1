"""Port of `pixelsplat_tpu/geometry`."""
