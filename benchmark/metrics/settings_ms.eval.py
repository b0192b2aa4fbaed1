"""Host milliseconds a scene of the render-settings probe's spans
(`settings.project`, `settings.occupancy` and the sync point
`settings.read`): the probe waits on the device, so its host time is what
the scene pays for it, over the traced scenes."""

from benchmark.program import per_scene


def read(run):
    return per_scene(run, ("settings.project", "settings.occupancy", "settings.read"), clock="host_ms")
