"""Scene time: the window's length over the scenes it completed (host
clock, each scene synchronised at its end)."""


def read(run):
    if run.kind != "eval" or not run.done:
        return None
    return 1e3 * run.window_s / run.done
