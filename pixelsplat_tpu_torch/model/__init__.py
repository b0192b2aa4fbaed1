"""Port of `pixelsplat_tpu/model`."""
