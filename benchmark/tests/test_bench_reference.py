"""The plain reference against the program at a tiny size on the CPU, so
that both stay honest: the encoder's Gaussians and the rasterizer's
images."""

from __future__ import annotations

import copy
from types import SimpleNamespace

import pytest
import torch

from benchmark import check, generator, port, spec, weights as wts
from benchmark.reference import encoder as encoder_module, rasterizer as rast
from benchmark.reference.encoder import Encoder, apply_shims

from .conftest import TINY, tiny_cell

SEED = 2**31 + 99


def _units(config=TINY):
    return generator.make_units(tiny_cell("re10k.eval").traffic, config, SEED, "cpu")


@pytest.mark.parametrize("views", [2, 3])
def test_encoder_matches_program(views):
    config = copy.deepcopy(TINY)
    config["encoder"]["num_context_views"] = views
    wrapper = port.build(config, SEED, "cpu")
    reference = check.reference_encoder(config, SEED, "cpu")
    unit = _units(config=config)[0]
    program = wrapper.make_eval_encode(pack_soa=False)(unit.batch, False, 0, u=unit.u, view_order=unit.view_order)
    with torch.no_grad():
        ours = reference(apply_shims(unit.batch, config["encoder"])["context"], 0, unit.u, unit.view_order)
    for p, r in zip(program, ours):
        assert p.shape == r.shape
        torch.testing.assert_close(p, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


def test_rasterizer_matches_program():
    wrapper = port.build(TINY, SEED, "cpu")
    unit = _units()[0]
    gaussians = wrapper.make_eval_encode(pack_soa=False)(unit.batch, False, 0, u=unit.u)
    t = unit.batch["target"]
    color, overflow = wrapper.make_eval_decode()(gaussians, t["extrinsics"], t["intrinsics"], t["near"], t["far"], (32, 32))
    images, works = rast.render_views(
        gaussians.means[0], gaussians.covariances[0], gaussians.harmonics[0], gaussians.opacities[0],
        t["extrinsics"][0], t["intrinsics"][0], t["near"][0], (32, 32), torch.zeros(3),
    )
    assert int(overflow) == 0
    # Both stop a tile once all its pixels are under 1e-4, the program after
    # a chunk of its list, the reference after a pair: what the program adds
    # after that is < 1e-4 of a colour.
    torch.testing.assert_close(color[0], images, rtol=0, atol=2e-4 * float(images.max()))
    assert all(w.pairs > 0 and w.gaussians <= w.pairs for w in works)


def test_weights_are_the_same_for_both_sides():
    wrapper = port.build(TINY, SEED, "cpu")
    with torch.device("meta"):
        template = wts.shapes_of(Encoder(TINY["encoder"]))
    ours = wts.encoder_weights(template, SEED, "cpu")
    theirs = wrapper.encoder.state_dict()
    assert set(ours) == set(theirs)
    for name in ours:
        assert torch.equal(ours[name], theirs[name]), name


def test_settling_moves_a_draw_off_a_bucket_edge():
    """pixelSplat's reference moves a depth uniform that lies on an edge of
    its cumulative bucket distribution into a bucket, and leaves the draws
    away from the edges as made."""
    unit = _units()[0]
    encoder = check.reference_encoder(TINY, SEED, "cpu")
    with torch.no_grad():
        _, pdf, _ = encoder.depth_distribution(apply_shims(unit.batch, TINY["encoder"])["context"])
    upper = torch.cumsum(pdf, -1)
    unit.u[0, 0, 0, 0, 0] = upper[0, 0, 0, 0, 0]
    settled = check.settle_depth_draws([unit], TINY, SEED, "cpu")[0].u
    edges = torch.cat([torch.zeros_like(upper[..., :1]), upper], -1)
    assert float((edges[0, 0, 0, 0] - settled[0, 0, 0, 0, 0]).abs().min()) >= encoder_module.EDGE_MARGIN
    away = (upper[..., None, :] - unit.u[..., None]).abs().amin(-1) >= encoder_module.EDGE_MARGIN
    assert torch.equal(settled[away], unit.u[away])


def test_settling_dispatches_to_the_reference_module(monkeypatch):
    """The module's `settle_draws` settles, given the seed's reference
    encoder; a module without one leaves the units as made."""
    units = _units()[:2]
    monkeypatch.setattr(spec, "reference_module", lambda config: SimpleNamespace(Encoder=Encoder, apply_shims=apply_shims))
    assert check.settle_depth_draws(units, TINY, SEED, "cpu") is units
    calls = []

    def settle_draws(units, encoder, cfg, device):
        calls.append((encoder, cfg, device))
        return units[::-1]

    monkeypatch.setattr(spec, "reference_module", lambda config: SimpleNamespace(
        Encoder=Encoder, apply_shims=apply_shims, settle_draws=settle_draws))
    assert check.settle_depth_draws(units, TINY, SEED, "cpu") == units[::-1]
    (encoder, cfg, device), = calls
    assert isinstance(encoder, Encoder) and cfg is TINY["encoder"] and device == "cpu"
