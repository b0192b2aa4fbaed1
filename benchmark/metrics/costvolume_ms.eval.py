"""Device milliseconds a scene of the program's span `encoder.costvolume`:
MVSplat's plane sweep (each view's pixels lifted at every candidate depth
and projected into the other views), the bilinear gathers of their
features, the correlation and its mean over the other views, over the
traced scenes."""

from benchmark.program import per_scene


def read(run):
    return per_scene(run, ("encoder.costvolume",))
