"""Device milliseconds a scene of the program's span `encoder.epipolar`:
the epipolar transformer's downscaler, its sampling along epipolar lines,
the depth encoding, the view embeddings and the attention stack, over the
traced scenes."""

from benchmark.program import per_scene


def read(run):
    return per_scene(run, ("encoder.epipolar",))
