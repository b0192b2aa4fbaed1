"""The plain references that decide `correct`: one module a model, found by
the configuration file's top-level `"reference"` (`encoder`, pixelSplat's
epipolar encoder, where the file has none; `spec.reference_module`), and
the rasterizer and geometry they share.

A reference module holds:

- `Encoder(encoder_cfg: dict)`, an `nn.Module` built from the configuration's
  `encoder` section, whose state-dict names are the program's, so that one
  state dict of the seed's weights loads into both. Its
  `forward(context, step, u, view_order)` takes the shimmed context views
  (image (b, v, 3, h, w), extrinsics, intrinsics, near, far), the step, the
  scene's uniforms `u` (shape `generator.u_shape`) and the view order (or
  None) and returns the means (b, g, 3), covariances (b, g, 3, 3),
  harmonics (b, g, 3, d_sh) and opacities (b, g).
- `apply_shims(batch: dict, encoder_cfg: dict) -> dict`, the batch the
  encoder sees.
- Optionally `settle_draws(units, encoder, encoder_cfg, device) -> list`,
  the units with their draws moved off the reference's discontinuities,
  where two correct float32 programs could place a Gaussian differently.
  Without it, the checked units are compared as made.

Every module here imports its siblings, `torch`, `numpy` and a few modules
of the standard library, and nothing of the program under test
(`tests/test_bench_isolation.py`).
"""
