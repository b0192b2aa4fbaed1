"""Port of `pixelsplat_tpu/interop`."""
