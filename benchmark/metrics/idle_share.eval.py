"""Share of the traced scenes' window in which no kernel, copy or set ran on
the device: one minus the union of device intervals over the window."""


def read(run):
    if run.kind != "eval" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
