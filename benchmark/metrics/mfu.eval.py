"""Model FLOPs of the scenes completed after the traced part of the window
(`flops/<config>.json`, counted from the reference's shapes), over that
time, as a share of the H100's 67 TFLOP/s float32 peak."""

from benchmark.work import PEAK_FLOPS


def read(run):
    if run.kind != "eval" or not run.after_trace_done or "eval_scene" not in run.work.get("flops", {}):
        return None
    return 100.0 * run.work["flops"]["eval_scene"] * run.after_trace_done / run.after_trace_s / PEAK_FLOPS
