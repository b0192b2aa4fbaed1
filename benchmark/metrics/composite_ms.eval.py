"""Device milliseconds a rendered view of the program's span
`render.composite`: packing the parameter table, the compositing kernel K1
and assembling the image, over the traced scenes."""

from benchmark.program import per_view


def read(run):
    return per_view(run, ("render.composite",))
