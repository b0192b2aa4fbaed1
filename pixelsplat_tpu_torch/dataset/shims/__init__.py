"""Port of `pixelsplat_tpu/dataset/shims`."""
