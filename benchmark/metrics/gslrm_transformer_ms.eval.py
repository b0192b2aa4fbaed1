"""Device milliseconds a scene of the program's span `encoder.transformer`:
GS-LRM's 24 blocks over both context views' tokens as one sequence and the
final LayerNorm, over the traced scenes. A program without the span reads
nothing."""

from benchmark import program


def read(run):
    found = program.read(run)
    if found is None or not program.calls(found, "encoder.transformer"):
        return None
    return program.per_scene(run, ("encoder.transformer",))
