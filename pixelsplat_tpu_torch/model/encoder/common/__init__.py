"""Port of `pixelsplat_tpu/model/encoder/common`."""
