"""Device milliseconds a scene of the program's span `encoder.depth_refine`:
MVSplat's full-resolution refinement (the feature upsampler and projection,
the refinement U-Net and the disparity and density head), over the traced
scenes."""

from benchmark.program import per_scene


def read(run):
    return per_scene(run, ("encoder.depth_refine",))
