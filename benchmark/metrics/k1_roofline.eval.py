"""K1 (`csrc/composite_fwd.cu`) as a share of its roofline over the traced
scenes: the least time the H100 needs for the work the reference counted
on those scenes' views (`work.k1_work`), over K1's device time in the
trace. The kernel is found by the symbol below."""

from benchmark.work import k1_work, roofline_share

PATTERN = r"composite_fwd_kernel"


def read(run):
    if run.kind != "eval" or run.trace is None or not run.work.get("views"):
        return None
    seconds = run.trace.kernel_seconds(PATTERN)
    if seconds <= 0:
        return None
    return roofline_share(*k1_work(run.work["views"]), seconds)[0]
