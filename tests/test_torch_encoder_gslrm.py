"""GS-LRM's encoder (`model/encoder/encoder_gslrm.py`) against the
benchmark's plain reference (`benchmark/reference/gslrm.py`) on seeded
random weights at a small size (2 blocks of width 64 and 4 heads, patch 8,
2 views at 32x32), and checks that go through neither: the Plücker rays of
a known camera by hand, the joint attention across the views, and a render
at SH degree 0 through the port's decoder against the reference
rasterizer. Also the `gslrm` preset and the encoder choice.

The test marked `cuda` runs at the `gslrm.eval` cell's widths on the card
and imports nothing of the JAX package:

    python -m pytest tests/test_torch_encoder_gslrm.py -m cuda --noconftest -p no:cacheprovider
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import weights as wts
from benchmark.reference import gslrm as ref
from benchmark.reference import rasterizer as rast
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.geometry.projection import plucker_rays
from pixelsplat_tpu_torch.model.encoder.encoder_gslrm import EncoderGslrm, patchify, unpatchify
from pixelsplat_tpu_torch.ops.rasterizer.projection import GaussiansSoA
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper
from pixelsplat_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 24
SIZE = 32


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.enable(False)
    tracing.reset()
    yield
    torch.set_num_threads(threads)
    tracing.enable(False)
    tracing.reset()


def tiny_cfg():
    """`gslrm()` at a test's size: 2 blocks of width 64 and 4 heads, every
    other setting as published."""
    return dataclasses.replace(pt_config.gslrm()[0], depth=2, d_model=64, heads=4)


def context(dtype=torch.float32, seed: int = 2) -> dict:
    """Noise images on two cameras along x at baseline 1, near 1 and far 100."""
    g = torch.Generator().manual_seed(seed)
    e = torch.eye(4).repeat(1, 2, 1, 1)
    e[:, :, 0, 3] = torch.linspace(0, 1, 2)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]).repeat(1, 2, 1, 1)
    ctx = {"image": torch.rand(1, 2, 3, SIZE, SIZE, generator=g), "extrinsics": e, "intrinsics": k,
           "near": torch.ones(1, 2), "far": torch.full((1, 2), 100.0)}
    return {name: t.to(dtype) for name, t in ctx.items()}


def pair():
    """The program's encoder and the reference, holding the same seeded weights."""
    cfg = tiny_cfg()
    program = EncoderGslrm(cfg).eval()
    reference = ref.Encoder(dataclasses.asdict(cfg)).eval()
    state = wts.encoder_weights(wts.shapes_of(program), SEED, "cpu")
    program.load_state_dict(state, strict=True)
    reference.load_state_dict(state, strict=True)
    return program, reference


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(((a - b) ** 2).mean()) / torch.sqrt((b**2).mean()))


def as_aos(soa: GaussiansSoA) -> tuple:
    """SoA planes (one surface and sample, harmonics (b, 3, 1, v, 1, r)) in
    the AoS (v, r) order."""
    b, g = soa.mean_x.shape
    means = torch.stack([soa.mean_x, soa.mean_y, soa.mean_z], dim=-1)
    cov = torch.zeros(b, g, 3, 3, dtype=means.dtype)
    for row, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
        cov[:, :, i, j] = cov[:, :, j, i] = soa.cov[:, row]
    harm = soa.harmonics[:, :, :, :, 0].permute(0, 3, 4, 1, 2).reshape(b, g, 3, -1)
    return means, cov, harm, soa.opacity


def encode(program, ctx, pack_soa=False):
    with torch.no_grad():
        got = program(ctx, 0, False, pack_soa=pack_soa)
    return as_aos(got) if pack_soa else tuple(got)


def compare(pack_soa: bool, dtype) -> dict:
    program, reference = pair()
    program.to(dtype)
    reference.to(dtype)
    ctx = context(dtype)
    got = encode(program, ctx, pack_soa)
    with torch.no_grad():
        want = reference(ctx, 0, None, None)
    names = ("means", "covariances", "harmonics", "opacities")
    assert all(g.shape == w.shape for g, w in zip(got, want))
    return {name: rel_rms(g, w) for name, g, w in zip(names, got, want)}


@pytest.mark.parametrize("pack_soa", [False, True], ids=["aos", "soa"])
def test_port_matches_the_reference_in_float64(pack_soa):
    """The same arithmetic in other orders (the port's covariance entry by
    entry, its rays through the batched geometry): in float64 the two agree
    to 1e-15."""
    gaps = compare(pack_soa, torch.float64)
    assert max(gaps.values()) <= 1e-12, gaps


@pytest.mark.parametrize("pack_soa", [False, True], ids=["aos", "soa"])
def test_port_matches_the_reference_in_float32(pack_soa):
    """In float32 each quantity within 5e-6: the port reads 1.5e-7-8.2e-7
    from the reference (the covariances, a product of two rotations and two
    squared scales, the most), its float32 rounding through the two blocks
    against the reference's float64; TF32 products would be some 1e-3
    off."""
    gaps = compare(pack_soa, torch.float32)
    assert max(gaps.values()) <= 5e-6, gaps


# The rays, the patches and the attention, without the reference.


def test_plucker_rays_of_a_known_camera():
    """A camera at (1, 2, 3) turned 90 degrees about z, focal 0.5 x 1.0
    (normalized) and the principal point at the centre, 4x8 pixels: the
    pixel in row 1, column 6 has its centre at (6.5 / 8, 1.5 / 4) = (0.8125,
    0.375), so its camera ray is (0.625, -0.125, 1), in the world (0.125,
    0.625, 1), over its norm sqrt(1.40625); its moment o x d is (2 - 3 x
    0.625, 3 x 0.125 - 1, 0.625 - 2 x 0.125) = (0.125, -0.625, 0.375) over
    the same norm. Every ray's moment is the same from any of its points
    and is orthogonal to its direction."""
    e = torch.eye(4, dtype=torch.float64)
    e[:3, :3] = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    e[:3, 3] = torch.tensor([1.0, 2.0, 3.0])
    k = torch.tensor([[0.5, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], dtype=torch.float64)
    rays, origins, directions = plucker_rays(e, k, (4, 8))
    assert rays.shape == (4, 8, 6) and origins.shape == directions.shape == (4, 8, 3)
    norm = math.sqrt(1.40625)
    want = torch.tensor([0.125, -0.625, 0.375, 0.125, 0.625, 1.0], dtype=torch.float64) / norm
    torch.testing.assert_close(rays[1, 6], want, rtol=0, atol=1e-15)
    moment, d = rays[..., :3], rays[..., 3:]
    torch.testing.assert_close(torch.linalg.vector_norm(d, dim=-1), torch.ones(4, 8, dtype=torch.float64))
    torch.testing.assert_close((moment * d).sum(-1), torch.zeros(4, 8, dtype=torch.float64), rtol=0, atol=1e-15)
    torch.testing.assert_close(torch.linalg.cross(origins + 5.0 * d, d), moment, rtol=0, atol=1e-14)


def test_patchify_and_unpatchify_are_inverse_in_row_column_channel_order():
    x = torch.arange(2 * 3 * 16 * 24 * 5, dtype=torch.float32).reshape(2, 3, 16, 24, 5)
    tokens = patchify(x, 8)
    assert tokens.shape == (2, 3 * 2 * 3, 8 * 8 * 5)
    # Token 4 is view 0's patch in row 1, column 1; its value 9 is pixel (0, 1), channel 4.
    assert float(tokens[1, 4, 9]) == float(x[1, 0, 8, 9, 4])
    assert torch.equal(unpatchify(tokens, 3, 16, 24, 8), x)


def test_attention_is_joint_across_the_views():
    """Swapping the two context views (images and cameras) permutes the
    Gaussians and nothing else: no embedding tells the views apart. And
    changing one view's image changes the other view's Gaussians, which a
    view-by-view transformer would not. In float64, so that the attention's
    sums in another order agree to 1e-13."""
    program, _ = pair()
    program.to(torch.float64)
    ctx = context(torch.float64)
    swapped = {name: t.flip(1) for name, t in ctx.items()}
    got, want = encode(program, swapped), encode(program, ctx)
    g = SIZE * SIZE
    for a, b in zip(got, want):
        assert rel_rms(torch.cat([a[:, g:], a[:, :g]], dim=1), b) <= 1e-13
    other = {**ctx, "image": ctx["image"].clone()}
    other["image"][:, 1] = torch.rand(3, SIZE, SIZE, generator=torch.Generator().manual_seed(9), dtype=torch.float64)
    changed = encode(program, other)
    for a, b in zip(changed, want):
        assert rel_rms(a[:, :g], b[:, :g]) > 1e-4  # view 0's Gaussians moved


def test_render_at_sh_degree_0_matches_the_reference_rasterizer():
    """The port's Gaussians of a tiny `gslrm` scene (one harmonic a colour)
    through the port's decoder and through the reference rasterizer. Both
    stop a tile once all its pixels are under 1e-4 transmittance, the
    program after a chunk of its list, the reference after a pair: what the
    program adds after that is under 1e-4 of a colour."""
    from benchmark import generator, port

    config = json.loads((ROOT / "benchmark" / "configs" / "gslrm.json").read_text())
    config["image_shape"] = [SIZE, SIZE]
    config["encoder"].update(depth=2, d_model=64, heads=4)
    traffic = {**json.loads((ROOT / "benchmark" / "traffic" / "eval.json").read_text()), "pool": 1}
    wrapper = port.build(config, SEED, "cpu")
    unit = generator.make_units(traffic, config, SEED, "cpu")[0]
    gaussians = wrapper.make_eval_encode(pack_soa=False)(unit.batch, False, 0)
    assert gaussians.harmonics.shape == (1, 2 * SIZE * SIZE, 3, 1)
    t = unit.batch["target"]
    color, overflow = wrapper.make_eval_decode()(
        gaussians, t["extrinsics"], t["intrinsics"], t["near"], t["far"], (SIZE, SIZE)
    )
    images, works = rast.render_views(
        gaussians.means[0], gaussians.covariances[0], gaussians.harmonics[0], gaussians.opacities[0],
        t["extrinsics"][0], t["intrinsics"][0], t["near"][0], (SIZE, SIZE), torch.zeros(3),
    )
    assert int(overflow) == 0
    assert all(w.pairs > 0 for w in works)
    torch.testing.assert_close(color[0], images, rtol=0, atol=2e-4 * float(images.max()))


# The preset, the encoder choice and the tracer.


def test_gslrm_preset_holds_the_published_widths():
    encoder, decoder = pt_config.gslrm()
    assert (encoder.name, encoder.patch_size, encoder.d_model, encoder.depth, encoder.heads, encoder.mlp_ratio) == (
        "gslrm", 8, 1024, 24, 16, 4
    )
    assert (encoder.num_context_views, encoder.sh_degree, encoder.compute_dtype) == (2, 0, None)
    render = dataclasses.replace(pt_config.re10k()[1].render, span=3, capacity=8192, big_capacity=8192,
                                 pair_budget=3_309_568, force_wide_keys=True)
    assert decoder == dataclasses.replace(pt_config.re10k()[1], render=render)
    # The pair budget is span 3's worst case for the small Gaussians of a
    # 2-view 256 x 256 scene beside a full big list in every tile.
    assert render.pair_budget == render.span**2 * 2 * 256 * 256 + 16 * 16 * (render.big_capacity + render.chunk)
    with torch.device("meta"):
        model = EncoderGslrm(encoder)
    # The patch's layer 576 -> 1024, 24 blocks of 12.6M, the final norm, the head 1024 -> 768.
    block = 4 * 1024 + 1024 * 3072 + 3072 + 1024 * 1024 + 1024 + 1024 * 4096 + 4096 + 4096 * 1024 + 1024
    assert sum(p.numel() for p in model.parameters()) == 577 * 1024 + 24 * block + 2 * 1024 + 1025 * 768
    assert sum(p.numel() for p in model.parameters()) == 303_689_472


def test_model_wrapper_builds_the_gslrm_encoder_and_its_shim():
    with torch.device("meta"):
        wrapper = ModelWrapper(*pt_config.gslrm(), device="meta")
    assert type(wrapper.encoder) is EncoderGslrm
    views = {"image": torch.zeros(1, 2, 3, 72, 78), "intrinsics": torch.eye(3).repeat(1, 2, 1, 1),
             "near": torch.ones(1, 2), "far": torch.full((1, 2), 100.0)}
    shimmed = wrapper.data_shim({"context": views, "target": views})
    assert shimmed["context"]["image"].shape[-2:] == (72, 72)  # centre-cropped to a multiple of 8
    assert torch.equal(shimmed["context"]["far"], views["far"])  # no bounds shim
    with pytest.raises(ValueError, match="float32"):
        EncoderGslrm(dataclasses.replace(pt_config.gslrm()[0], compute_dtype="bfloat16"))
    with pytest.raises(ValueError, match="SH degree 0"):
        EncoderGslrm(dataclasses.replace(pt_config.gslrm()[0], sh_degree=2))


def test_stages_are_spanned_and_the_tokens_counted():
    program, _ = pair()
    tracing.enable(True)
    with torch.no_grad():
        program(context(), 0, False, pack_soa=True)
    found = tracing.read()
    assert {k: v["calls"] for k, v in found["spans"].items() if k.startswith("encoder.")} == {
        f"encoder.{s}": 1 for s in ("backbone", "transformer", "heads")
    }
    assert found["counters"]["gslrm_tokens"] == 2 * (SIZE // 8) ** 2
    assert found["counters"]["gaussians"] == 2 * SIZE * SIZE


def test_one_training_step_reaches_every_weight():
    """The loss's gradient through the encoder (autograd, no graphs) reaches
    every parameter."""
    program, _ = pair()
    gaussians = program(context(), 0, False)
    loss = sum(t.square().mean() for t in gaussians)
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in program.parameters())
    assert float(program.tokenizer.weight.grad.abs().sum()) > 0


# On the card, at the cell's widths.


@pytest.mark.cuda
def test_card_graphs_equal_eager_at_the_cell_widths():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark import generator, gslrm_work, port, spec
    from pixelsplat_tpu_torch.training.model_wrapper import batch_to

    cell = spec.load_cell("gslrm.eval")
    port.set_precision(cell.config)
    wrapper = port.build(copy.deepcopy(cell.config), SEED, "cuda")
    units = generator.make_units({**cell.traffic, "pool": 2}, cell.config, SEED, "cuda")
    tracing.enable(True)
    for unit in units + units:  # the second pass replays
        ctx = wrapper.data_shim(batch_to(unit.batch, "cuda"))["context"]
        with torch.no_grad():
            eager = wrapper.encoder(ctx, 0, False, pack_soa=True, visualization_dump={})
            graphed = wrapper.encoder(ctx, 0, False, pack_soa=True)
        torch.cuda.synchronize()
        assert all(x is None and y is None or torch.equal(x, y) for x, y in zip(graphed, eager))
    assert tracing.counter("encoder_graph_captures") == 1 and tracing.counter("encoder_graph_scenes") == 4
    # 2,048 tokens and 98 K10 launches a scene, eager or replayed: 8 scenes;
    # their work the hand count of `benchmark/gslrm_work.py`; no layer plain.
    assert tracing.counter("gslrm_tokens") == 8 * 2048
    assert tracing.counter("linear_split_launches") == 8 * 98
    assert tracing.counter("linear_split_flops.traced") == 8 * 2048 * gslrm_work.flop_per_token(cell.config["encoder"])
    assert tracing.counter("linear_plain_on_card") == 0
