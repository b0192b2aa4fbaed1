"""Device milliseconds a rendered view of the program's spans
`render.project` and `render.bin`: projecting the scene's Gaussians into
the view and binning them into tile lists, over the traced scenes."""

from benchmark.program import per_view


def read(run):
    return per_view(run, ("render.project", "render.bin"))
