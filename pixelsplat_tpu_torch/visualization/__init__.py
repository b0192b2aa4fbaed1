"""Port of `pixelsplat_tpu/visualization`: layout and labels, colour maps,
the drawing primitives, camera trajectories and the validation's 3D views."""
