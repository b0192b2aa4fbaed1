"""Device milliseconds a scene of the program's span `encoder.backbone`:
DINO ViT-B/8 with its ResNet-50 and the 1x1 projection to d_feature, over
the traced scenes (CUDA events the program records inside the encoder)."""

from benchmark.program import per_scene


def read(run):
    return per_scene(run, ("encoder.backbone",))
