"""K10 (`csrc/linear_split.cu`), the DINO ViT's four linear layers, as a
share of its roofline over the traced scenes: the least time the H100 needs
for their operations in split precision (three TF32 products a
multiply-add, so 495 / 3 TFLOP/s), over K10's device time in the trace. The
kernel is found by the symbol below; a checkout without it reads nothing.

The work is 2 * 768 * 9216 FLOP a token a block (qkv 768 -> 2304, proj 768
-> 768, fc1 768 -> 3072, fc2 3072 -> 768) over ViT-B/8's 12 blocks, at the
widths both configurations use; the tokens are those of the traced scenes'
context views, one per 8x8 patch and the CLS token."""

PATTERN = r"linear_split_kernel"
PEAK_SPLIT_FLOPS = 495e12 / 3  # H100 SXM TF32 tensor cores, three products
DIM, DEPTH, PATCH = 768, 12, 8
FLOP_PER_TOKEN = 2 * DIM * (3 * DIM + DIM + 4 * DIM + 4 * DIM) * DEPTH


def tokens(h: int, w: int) -> int:
    return (h // PATCH) * (w // PATCH) + 1


def read(run):
    if run.kind != "eval" or run.trace is None or not run.traced:
        return None
    seconds = run.trace.kernel_seconds(PATTERN)
    if seconds <= 0:
        return None
    units = run.outputs["units"]
    count = 0
    for i in run.traced:
        b, v, _, h, w = units[i].batch["context"]["image"].shape
        count += b * v * tokens(h, w)
    return 100.0 * FLOP_PER_TOKEN * count / PEAK_SPLIT_FLOPS / seconds
