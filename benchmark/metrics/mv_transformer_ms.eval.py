"""Device milliseconds a scene of the program's span `encoder.mv_transformer`:
MVSplat's multi-view transformer (the window position encoding and 6 blocks
of windowed self-attention and cross-view attention with the feed-forward),
over the traced scenes."""

from benchmark.program import per_scene


def read(run):
    return per_scene(run, ("encoder.mv_transformer",))
