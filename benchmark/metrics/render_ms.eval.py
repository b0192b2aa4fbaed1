"""Device time of `choose_eval_settings` and the `make_eval_decode()` calls
per target view, from the benchmark's CUDA events around them, over the
traced run's window."""


def read(run):
    settings, render = run.spans_ms.get("settings"), run.spans_ms.get("render")
    if run.kind != "eval" or not settings or not render:
        return None
    return (sum(settings) + sum(render)) / (len(render) * run.views)
