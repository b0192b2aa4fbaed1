"""95th percentile of every scene latency of the window (host clock): from
the host batch handed to the encode entry to the synchronised end of the
scene's last render."""

import statistics


def read(run):
    if run.kind != "eval" or len(run.latencies_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.latencies_s, n=100, method="inclusive")[94]
