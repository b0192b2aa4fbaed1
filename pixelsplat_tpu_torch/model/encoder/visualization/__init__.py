"""Port of `pixelsplat_tpu/model/encoder/visualization`: the encoder figures."""
