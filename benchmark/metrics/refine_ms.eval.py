"""Device milliseconds a scene of the program's span `encoder.refine`: the
epipolar transformer's transposed-conv upscaler and its two 7x7
refinement convolutions, over the traced scenes."""

from benchmark.program import per_scene


def read(run):
    return per_scene(run, ("encoder.refine",))
