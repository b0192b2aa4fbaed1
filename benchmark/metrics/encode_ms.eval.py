"""Device time of the encode entry (`make_eval_encode(pack_soa=True)`'s
call) per scene, from the benchmark's CUDA events around it, over the
traced run's window."""

import statistics


def read(run):
    spans = run.spans_ms.get("encode")
    return statistics.fmean(spans) if run.kind == "eval" and spans else None
