"""The render-settings rules on hand-made occupancies, and the probe's reads.

`choose_settings` and `sufficient_settings` are host arithmetic on the
probe's `Occupancy`, so each case below states the occupancy and the
settings that must come out of it. The probe itself is held against the
JAX package and the plain counts elsewhere (`test_torch_rasterizer.py`,
`test_torch_project_bin.py`, `test_torch_depth_render.py`).
"""

from dataclasses import replace

import pytest
import torch

from pixelsplat_tpu_torch.ops.rasterizer.adaptive import Occupancy, choose_settings, probe, sufficient_settings
from pixelsplat_tpu_torch.ops.rasterizer.binning import default_pair_budget
from pixelsplat_tpu_torch.ops.rasterizer.projection import aos_planes
from pixelsplat_tpu_torch.ops.rasterizer.render import RenderSettings
from pixelsplat_tpu_torch.utils import tracing

IMAGE = (64, 64)  # 16 tiles of 16x16
TILES = 16
SETTINGS = RenderSettings(capacity=4096, span=2, big_capacity=64, chunk=128)


def worst(g: int, big_capacity: int = 64) -> int:
    return SETTINGS.span**2 * g + TILES * (big_capacity + SETTINGS.chunk)


# name -> (occupancy, Gaussians, want (capacity, big_capacity, pair_budget))
CHOOSE = {
    "demand a whole number of chunks": (Occupancy(300, 547 * 128, 64), 100_000, (512, 64, 547 * 128)),
    "demand one pair past a chunk": (Occupancy(300, 547 * 128 + 1, 64), 100_000, (512, 64, 548 * 128)),
    "capacity snapped to the next candidate": (Occupancy(513, 70_000, 64), 100_000, (1024, 64, 547 * 128)),
    "a list longer than every candidate": (Occupancy(2049, 70_000, 64), 100_000, (4096, 64, 547 * 128)),
    "big list grown by the probe": (Occupancy(300, 70_000, 192), 100_000, (512, 192, 547 * 128)),
    "demand above the worst case": (Occupancy(300, 10**6, 64), 20_001, (512, 64, -(-worst(20_001) // 128) * 128)),
    "worst case of the grown big list": (
        Occupancy(300, 10**6, 192), 20_001, (512, 192, -(-worst(20_001, 192) // 128) * 128),
    ),
    "demand under the 65,536 floor": (Occupancy(300, 1_000, 64), 100_000, (512, 64, 65_536)),
    "worst case under the floor": (Occupancy(300, 10**6, 64), 1_000, (512, 64, 65_536)),
}


@pytest.mark.parametrize("case", list(CHOOSE))
def test_choose_settings_rule(case):
    occupancy, g, want = CHOOSE[case]
    got = choose_settings(occupancy, SETTINGS, g, IMAGE)
    assert (got.capacity, got.big_capacity, got.pair_budget) == want
    assert (got.span, got.chunk, got.tile_size) == (SETTINGS.span, SETTINGS.chunk, SETTINGS.tile_size)


# name -> (occupancy, the settings' pair budget, want pair_budget)
SET_BUDGET = {
    "demand under a set budget": (Occupancy(300, 70_000, 64), 200_000, -(-200_000 // 128) * 128),
    "demand over a set budget": (Occupancy(300, 300_000, 64), 200_000, -(-300_000 // 128) * 128),
}


@pytest.mark.parametrize("case", list(SET_BUDGET))
def test_choose_settings_keeps_a_set_pair_budget(case):
    """A pair budget in the settings is a floor: the probe's demand only
    grows it."""
    occupancy, budget, want = SET_BUDGET[case]
    got = choose_settings(occupancy, replace(SETTINGS, pair_budget=budget), 100_000, IMAGE)
    assert (got.capacity, got.big_capacity, got.pair_budget) == (512, 64, want)


def test_choose_settings_counts_what_it_chose():
    tracing.reset()
    tracing.enable(True)
    try:
        got = choose_settings(Occupancy(300, 70_000, 192), SETTINGS, 100_000, IMAGE)
    finally:
        tracing.enable(False)
    counters = tracing.read()["counters"]
    tracing.reset()
    assert (counters["capacity"], counters["pair_budget"], counters["big_capacity"]) == (512, got.pair_budget, 192)


# name -> (occupancy, settings, want (capacity, big_capacity, pair_budget)); None: `settings` itself
SUFFICIENT = {
    "settings that hold": (Occupancy(4096, 5_000, 64), SETTINGS, None),
    # The default budget at g = 1,000: min(4 g + 16 (64 + 128), 65,536) = 7,072.
    "demand equal to the default budget": (Occupancy(100, 7_072, 64), SETTINGS, None),
    "a set pair budget that holds": (Occupancy(100, 8_192, 64), RenderSettings(pair_budget=8_192), None),
    "a list one past the capacity": (Occupancy(4097, 5_000, 64), SETTINGS, (4224, 64, None)),
    "a list a whole number of chunks long": (Occupancy(4224, 5_000, 64), SETTINGS, (4224, 64, None)),
    "a longer big list": (Occupancy(100, 5_000, 192), SETTINGS, (4096, 192, None)),
    "demand one past the default budget": (Occupancy(100, 7_073, 64), SETTINGS, (4096, 64, 56 * 128)),
    "demand above the default budget": (Occupancy(100, 80_001, 64), SETTINGS, (4096, 64, 626 * 128)),
    "demand above a set budget": (
        Occupancy(100, 8_193, 64), RenderSettings(chunk=64, pair_budget=8_192), (4096, 256, 129 * 64),
    ),
}


@pytest.mark.parametrize("case", list(SUFFICIENT))
def test_sufficient_settings_rule(case):
    occupancy, settings, want = SUFFICIENT[case]
    g = 1_000
    got = sufficient_settings(occupancy, settings, g, IMAGE)
    if want is None:
        assert got is settings
        return
    assert (got.capacity, got.big_capacity, got.pair_budget) == want
    # No pair dropped: the budget (or its default at the chosen sizes) holds the demand.
    budget = got.pair_budget or default_pair_budget(g, TILES, got.big_capacity, got.span, got.chunk)
    assert got.capacity >= occupancy.max_count and budget >= occupancy.pair_demand


@pytest.mark.parametrize("shared", [False, True], ids=["per_view_planes", "shared_planes"])
def test_a_probe_reads_back_twice(shared):
    """Two `settings.read` sync points a probe, whatever the views: the
    big-list count, then the largest list and the demand in one read."""
    gen = torch.Generator().manual_seed(0)
    g, views = 200, 3
    means = torch.stack([torch.rand(g, generator=gen) * 2 - 1, torch.rand(g, generator=gen) * 2 - 1,
                         torch.linspace(2.0, 6.0, g)], dim=-1)
    covs = torch.eye(3).expand(g, 3, 3) * 0.01
    opac = torch.rand(g, generator=gen)
    extr = torch.eye(4).repeat(views, 1, 1)
    extr[:, 0, 3] = torch.linspace(-0.3, 0.3, views)
    intr = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]).repeat(views, 1, 1)
    planes = aos_planes(means, covs, opac) if shared else aos_planes(
        means.expand(views, g, 3), covs.expand(views, g, 3, 3), opac.expand(views, g))
    tracing.reset()
    tracing.enable(True)
    try:
        occupancy = probe(extr, intr, torch.full((views,), 1.5), planes, IMAGE, SETTINGS)
    finally:
        tracing.enable(False)
    spans = tracing.read()["spans"]
    tracing.reset()
    assert spans["settings.read"]["calls"] == 2
    assert isinstance(occupancy, Occupancy) and all(type(x) is int for x in occupancy)
    assert 0 < occupancy.max_count and 0 < occupancy.pair_demand and occupancy.big_capacity >= SETTINGS.big_capacity
