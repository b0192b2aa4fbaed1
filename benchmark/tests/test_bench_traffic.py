"""The traffic generator: targets between the context cameras, as the
evaluation index draws them, and the same set of places for every seed."""

from __future__ import annotations

import torch

from benchmark import generator

from .conftest import TINY, tiny_cell


def _places(seed: int, views: int = 2) -> list:
    config = {**TINY, "encoder": {**TINY["encoder"], "num_context_views": views}}
    units = generator.make_units(tiny_cell("re10k.eval").traffic, config, seed, "cpu")
    out = []
    for unit in units:
        ctx = unit.batch["context"]["extrinsics"][0, :, 0, 3]
        tgt = unit.batch["target"]["extrinsics"][0, :, 0, 3]
        assert torch.equal(ctx, torch.linspace(0.0, 1.0, views)), ctx
        assert bool(((tgt > 0) & (tgt < 1)).all()) and bool((tgt[1:] > tgt[:-1]).all()), tgt
        out.append(tgt.tolist())
    return out


def test_targets_lie_between_the_context_cameras():
    _places(2**31 + 5)
    _places(2**31 + 5, views=3)


def test_every_seed_sends_the_same_places():
    a, b = _places(2**31 + 5), _places(2**33 + 17)
    assert a != b
    assert sorted(x for s in a for x in s) == sorted(x for s in b for x in s)
