"""K11 (`csrc/conv3x3.cu`), MVSplat's stride-1 3x3 convolutions, as a share
of its roofline over the traced scenes: the least time the H100 needs for
their operations in split precision (three TF32 products a multiply-add, so
495 / 3 TFLOP/s), over K11's device time in the trace. The kernel is found
by the symbol below, which no cuDNN kernel and neither K9's nor K10's holds;
a checkout without it reads nothing.

The work is counted from the configuration, not from the launches: the
reference model's (`reference/costvolume.py`) 87 stride-1 3x3 convolutions
with at least 8 output channels, 227,379,511,296 FLOP over 2 x 256 x 256
context pixels at `mvsplat`'s widths, 1,734,768 FLOP a context pixel
(`tests/test_bench_conv3x3.py`); the pixels and views are those of the
traced scenes' context images."""

PATTERN = r"conv3x3_split_kernel"
PEAK_SPLIT_FLOPS = 495e12 / 3  # H100 SXM TF32 tensor cores, three products
FLOP_PER_PIXEL = 1_734_768


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
