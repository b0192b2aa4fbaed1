"""From the process's start to the start of the window: imports, the
model and its weights, the traffic, kernel builds where the checkout has
none, and the warm-up."""


def read(run):
    return run.setup_s
