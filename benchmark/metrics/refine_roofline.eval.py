"""K9 (`csrc/conv7.cu`), the refinement's two 7x7 convolutions, as a share
of its roofline over the traced scenes: the least time the H100 needs for
their operations in split precision (three TF32 products a multiply-add, so
495 / 3 TFLOP/s), over K9's device time in the trace. The kernel is found by
the symbol below; a checkout without it reads nothing.

The work is 2 * 49 * (128 * 256 + 256 * 128) FLOP a context pixel (conv1
128 -> 256 and conv2 256 -> 128 channels, 7x7 taps), at the refinement's
widths for `d_feature` 128, which both configurations use; the pixels and
views are those of the traced scenes' context images."""

PATTERN = r"conv7_kernel"
PEAK_SPLIT_FLOPS = 495e12 / 3  # H100 SXM TF32 tensor cores, three products
D_FEATURE = 128
FLOP_PER_PIXEL = 2 * 49 * (D_FEATURE * 2 * D_FEATURE + 2 * D_FEATURE * D_FEATURE)


def read(run):
    if run.kind != "eval" or run.trace is None or not run.traced:
        return None
    seconds = run.trace.kernel_seconds(PATTERN)
    if seconds <= 0:
        return None
    units = run.outputs["units"]
    pixels = 0
    for i in run.traced:
        b, v, _, h, w = units[i].batch["context"]["image"].shape
        pixels += b * v * h * w
    return 100.0 * FLOP_PER_PIXEL * pixels / PEAK_SPLIT_FLOPS / seconds
