"""The benchmark's own work counts: model FLOPs from the reference's shapes
and the compositing work from the reference's own binning and early stop,
never from the lists the program allocates."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import generator, port, spec, work
from benchmark.reference import rasterizer as rast
from benchmark.reference.encoder import ViTBlock

from .conftest import TINY, tiny_cell


def test_vit_layer_flops_by_hand():
    n, d = 1025, 768
    with torch.device("meta"):
        block = ViTBlock(d, 12)
        x = torch.empty(1, n, d)
        with FlopCounterMode(display=False) as counter:
            block(x)
    assert counter.get_total_flops() == 24 * n * d * d + 4 * n * n * d


@pytest.mark.parametrize("name", ["re10k", "re10k_3_view"])
def test_flops_files_are_the_counts(name):
    config = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    assert work.flops_of(name) == work.count_flops(config)


def test_k1_count_ignores_the_programs_capacity():
    """The program renders the same image at two list capacities; the count
    the benchmark takes comes from the reference and is the same too."""
    unit = generator.make_units(tiny_cell("re10k.eval").traffic, TINY, 3, "cpu")[0]
    wrapper = port.build(TINY, 3, "cpu")
    gaussians = wrapper.make_eval_encode(pack_soa=False)(unit.batch, False, 0, u=unit.u)
    t = unit.batch["target"]
    images, counts = [], []
    for capacity in (6144, 12288):
        settings = dataclasses.replace(wrapper.decoder.cfg.render, capacity=capacity, big_capacity=6144, pair_budget=1 << 20)
        color, overflow = wrapper.make_eval_decode()(
            gaussians, t["extrinsics"], t["intrinsics"], t["near"], t["far"], (32, 32), settings
        )
        assert int(overflow) == 0
        images.append(color)
        _, works = rast.render_views(
            gaussians.means[0], gaussians.covariances[0], gaussians.harmonics[0], gaussians.opacities[0],
            t["extrinsics"][0], t["intrinsics"][0], t["near"][0], (32, 32), torch.zeros(3),
        )
        counts.append(work.k1_work(works))
    torch.testing.assert_close(images[0], images[1])
    assert counts[0] == counts[1] and counts[0][0] > 0


def test_roofline_share_names_its_bound():
    share, bound = work.roofline_share(67e12, 1.0, 2.0)
    assert share == pytest.approx(50.0) and bound == "operations"
    share, bound = work.roofline_share(1.0, 3.35e12, 4.0)
    assert share == pytest.approx(25.0) and bound == "bytes"


def test_early_stop_counts_fewer_pairs_than_the_lists():
    """An opaque front Gaussian stops every pixel of its tile: the pairs
    behind it are in the tile's list but not counted."""
    g = 5
    means = torch.tensor([[0.0, 0.0, 2.0 + i] for i in range(g)])
    covs = torch.eye(3).repeat(g, 1, 1) * 400.0
    harm = torch.zeros(g, 3, 1)
    opac = torch.full((g,), 0.9999)
    e, k = torch.eye(4), torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]])
    pr = rast.project(means, covs, harm, opac, e, k, torch.tensor(1.0), (16, 16))
    gid, _, count = rast.tile_pairs(pr, (16, 16))
    _, w = rast.render(pr, (16, 16), torch.zeros(3))
    assert int(count.sum()) == g
    assert w.pairs <= 3
