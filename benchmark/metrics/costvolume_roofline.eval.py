"""MVSplat's cost volume as a share of its roofline over the traced scenes:
the least time the H100 needs for the work, over the device time of the
program's span `encoder.costvolume`. The work is that of the cost volume,
whatever computes it, so a fused warp-and-correlate kernel reads on the
same scale as the plain gathers.

Operations: v (v - 1) D h' w' c x 10 (8 for the four-tap bilinear blend of
each channel, 2 for its product and sum) over 67 TFLOP/s. Bytes: 4 x (v c
h' w' features read once + v D h' w' correlations written once) over 3.35
TB/s. The least time is the larger of the two. D and c are MVSplat's
published 128 candidates and 128 channels; h' and w' are a quarter of the
traced scenes' context images."""

from benchmark.program import calls, read as program
from benchmark.work import PEAK_BYTES, PEAK_FLOPS

CANDIDATES, CHANNELS, DOWNSCALE = 128, 128, 4
OPS_PER_TAP_CHANNEL = 10


def work(views: int, h: int, w: int) -> tuple[float, float]:
    """(operations, bytes) of one scene's cost volume at context images of h x w."""
    pixels = (h // DOWNSCALE) * (w // DOWNSCALE)
    ops = views * (views - 1) * CANDIDATES * pixels * CHANNELS * OPS_PER_TAP_CHANNEL
    nbytes = 4 * (views * CHANNELS * pixels + views * CANDIDATES * pixels)
    return float(ops), float(nbytes)


def read(run):
    found = program(run)
    if found is None or not run.traced or not calls(found, "encoder.costvolume"):
        return None
    seconds = found["spans"]["encoder.costvolume"]["device_ms"] / 1e3
    b, v, _, h, w = run.outputs["units"][run.traced[0]].batch["context"]["image"].shape
    ops, nbytes = work(v, h, w)
    least = b * calls(found, "encoder.costvolume") * max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
    return 100.0 * least / seconds
