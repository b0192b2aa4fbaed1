"""Device milliseconds a scene of the program's span `encoder.cv_refine`:
MVSplat's cost-volume refinement (a convolution, the U-Net with attention
across the views, the residual, the depth head, the softmax over the
candidates and its expectation), over the traced scenes."""

from benchmark.program import per_scene


def read(run):
    return per_scene(run, ("encoder.cv_refine",))
