"""Share of the traced scenes whose encode was served by CUDA graph replays:
the program's counter `encoder_graph_scenes`, as counted while tracing was
on (`encoder_graph_scenes.traced`), over the calls of the span
`encoder.backbone`, in %. A program without the counter reads nothing."""

from benchmark.program import calls, read as program


def read(run):
    found = program(run)
    if found is None or "encoder_graph_scenes" not in found["counters"]:
        return None
    return 100.0 * found["counters"].get("encoder_graph_scenes.traced", 0) / calls(found, "encoder.backbone")
