"""Host waits on the device a scene: the program's `host_syncs` counter
(one a declared sync point) over the traced scenes."""

from benchmark.program import calls, read as program


def read(run):
    found = program(run)
    if found is None:
        return None
    return found["counters"].get("host_syncs", 0) / calls(found, "encoder.backbone")
