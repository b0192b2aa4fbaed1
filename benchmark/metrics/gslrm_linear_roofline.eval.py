"""K10 (`csrc/linear_split.cu`), GS-LRM's linear layers, as a share of its
roofline over the traced scenes: the least time the H100 needs for their
operations in split precision (three TF32 products a multiply-add, so 495 /
3 TFLOP/s), over K10's device time in the trace. The kernel is found by the
symbol below, which no cuBLAS symbol holds.

The work is what the program counts of the launches it made while traced,
2 M K N FLOP a launch (counter `linear_split_flops.traced`), so the share
holds at whatever widths the run's encoder has. At `gslrm`'s it is 98
launches a scene, the hand count of `benchmark/gslrm_work.py`. A checkout
without the symbol or the counter reads nothing."""

from benchmark import program

PATTERN = r"linear_split_kernel"
PEAK_SPLIT_FLOPS = 495e12 / 3  # H100 SXM TF32 tensor cores, three products


def read(run):
    if run.kind != "eval" or run.trace is None or not run.traced:
        return None
    seconds = run.trace.kernel_seconds(PATTERN)
    found = program.read(run)
    if seconds <= 0 or found is None or not found["counters"].get("linear_split_flops.traced"):
        return None
    return 100.0 * found["counters"]["linear_split_flops.traced"] / PEAK_SPLIT_FLOPS / seconds
