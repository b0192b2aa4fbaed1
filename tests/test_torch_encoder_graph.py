"""The encoder's CUDA graphs (`model/encoder/graphs.py`) and the device
constants they need (`utils/device_constants.py`).

On the CPU: each constant against the per-call construction it replaced, and
the graphs' plumbing (signatures, static inputs, replays, clones, recapture)
through an emulation of CUDA graphs, whose capture records every operation
and whose replay runs them again into the captured outputs. The tests marked
`cuda` run the real graphs at both benchmark configurations' shapes, with
seeded weights, against the eager encode on the card; they import nothing
of the JAX package:

    python -m pytest tests/test_torch_encoder_graph.py -m cuda --noconftest -p no:cacheprovider
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from pixelsplat_tpu_torch.model import encodings
from pixelsplat_tpu_torch.model.encoder.backbone import dino, resnet
from pixelsplat_tpu_torch.model.encoder.common import gaussian_adapter
from pixelsplat_tpu_torch.model.encoder.graphs import EncoderGraphs
from pixelsplat_tpu_torch.model.encoder.epipolar.epipolar_sampler import collect_other_views
from pixelsplat_tpu_torch.ops import sh
from pixelsplat_tpu_torch.utils import tracing
from pixelsplat_tpu_torch.utils.device_constants import on_device
from pixelsplat_tpu_torch.utils.pairings import generate_heterogeneous_index

ROOT = Path(__file__).resolve().parents[1]
TINY = json.loads((ROOT / "benchmark" / "tests" / "tiny_config.json").read_text())


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


# The device constants, each against the construction it replaced.


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resize_matrices_equal_the_per_call_ones(dtype):
    x = torch.randn(2, 3, 5, 7, generator=torch.Generator().manual_seed(0), dtype=dtype)
    mh = torch.as_tensor(resnet._resize_matrix(5, 16), device="cpu", dtype=dtype)
    mw = torch.as_tensor(resnet._resize_matrix(7, 12), device="cpu", dtype=dtype)
    assert torch.equal(resnet._bilinear_resize(x, (16, 12)), (mh @ x) @ mw.T)

    grid = torch.randn(1, 3, 4, 8, generator=torch.Generator().manual_seed(1))
    want = torch.einsum("bhwc,hH->bHwc", grid, torch.as_tensor(dino._keys_cubic_resize_matrix(3, 6)))
    want = torch.einsum("bhwc,wW->bhWc", want, torch.as_tensor(dino._keys_cubic_resize_matrix(4, 9)))
    assert torch.equal(dino.resize_pos_embed(grid, (6, 9)), want)


@pytest.mark.parametrize("v", [2, 3, 4])
def test_view_index_phases_and_pixel_size_equal_the_per_call_ones(v):
    target = torch.randn(2, v, 4, 4)
    index = torch.as_tensor(generate_heterogeneous_index(v)[1], device="cpu")
    assert torch.equal(collect_other_views(target, v), target[:, index])

    samples = torch.rand(3, 5, 1, generator=torch.Generator().manual_seed(v))
    octaves = torch.arange(4, dtype=samples.dtype)
    phases = torch.tensor([0.0, 0.5 * math.pi], dtype=samples.dtype)
    want = torch.sin(samples[..., None, None] * (2.0 * math.pi * 2.0**octaves)[:, None] + phases).reshape(3, 5, -1)
    assert torch.equal(encodings.positional_encoding(samples, 4), want)

    for dtype in (torch.float32, torch.bfloat16):
        got = gaussian_adapter.pixel_size((16 * v, 24), "cpu", dtype)
        want = torch.tensor([1.0 / 24, 1.0 / (16 * v)], dtype=dtype)
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_constants_equal_the_per_call_ones(degree):
    mask = torch.ones((degree + 1) ** 2)
    for d in range(1, degree + 1):
        mask[d**2:(d + 1) ** 2] = 0.1 * 0.25**d
    assert torch.equal(on_device("sh_mask", gaussian_adapter.sh_mask, degree, device="cpu"), mask)

    rotations = torch.linalg.qr(torch.randn(5, 3, 3, generator=torch.Generator().manual_seed(degree)))[0]
    dirs, pinv = sh._fixed_directions_and_pinv(degree)
    dirs, pinv = torch.as_tensor(dirs, dtype=rotations.dtype), torch.as_tensor(pinv, dtype=rotations.dtype)
    rotated = dirs @ rotations.transpose(-1, -2)
    basis = torch.stack(sh.sh_basis_components(rotated[..., 0], rotated[..., 1], rotated[..., 2], degree)[degree**2:],
                        dim=-1)
    assert torch.equal(sh.sh_rotation_matrix(rotations, degree), basis.transpose(-1, -2) @ pinv.T)


def test_a_constant_is_copied_once_per_key_in_a_declared_sync_point():
    tracing.enable(True)
    build = lambda n: np.arange(n, dtype=np.float32)  # noqa: E731
    first = on_device("probe_constant", build, 6, device="cpu")
    assert on_device("probe_constant", build, 6, device="cpu") is first
    wide = on_device("probe_constant", build, 6, device="cpu", dtype=torch.float64)
    assert wide.dtype == torch.float64 and wide is not first
    assert on_device("probe_constant", build, 7, device="cpu").shape == (7,)
    got = tracing.read()
    assert got["spans"]["upload.probe_constant"]["calls"] == 3 and got["counters"]["host_syncs"] == 3


def test_a_constant_made_under_inference_mode_serves_autograd_later():
    with torch.inference_mode():
        m = on_device("resize_matrix", resnet._resize_matrix, 3, 11, device="cpu", dtype=torch.float32)
    x = torch.randn(1, 1, 3, 2, requires_grad=True)
    (m @ x).sum().backward()
    assert torch.allclose(x.grad, m.sum(0)[None, None, :, None].expand(1, 1, 3, 2))


# The graphs' plumbing on the CPU, through emulated CUDA graphs.


class EmulatedGraph:
    """A CUDA graph's contract on the CPU: capture records each operation on
    its tensors, replay runs them again in order into the captured outputs,
    so that a replay reads whatever the static inputs hold then."""

    def __init__(self):
        self.ops = []

    def replay(self):
        for func, args, kwargs, out in self.ops:
            result = func(*args, **kwargs)
            for o, r in zip(tree_flatten(out)[0], tree_flatten(result)[0]):
                if isinstance(o, torch.Tensor) and o is not r:
                    o.copy_(r)


class _Record(TorchDispatchMode):
    def __init__(self, graph):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.graph.ops.append((func, args, kwargs, out))
        return out


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def emulated(monkeypatch):
    """CUDA graphs emulated on the CPU, and the encoder's choice of graphs
    taken with the CPU in the card's place."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", EmulatedGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, **kw: _Record(graph))
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)

    class CpuImage:
        def __init__(self, image):
            self.image = image

        def __getattr__(self, name):
            return True if name == "is_cuda" else getattr(self.image, name)

    replays = EncoderGraphs.replays
    monkeypatch.setattr(
        EncoderGraphs, "replays",
        staticmethod(lambda image, u, dump, capturing: replays(CpuImage(image), u, dump, capturing)),
    )


def _tiny(views: int):
    from benchmark import generator, port

    config = copy.deepcopy(TINY)
    config["encoder"]["num_context_views"] = views
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "eval.json").read_text())
    traffic.update(pool=2)
    torch.manual_seed(0)
    wrapper = port.build(config, 11, "cpu")
    return wrapper, generator.make_units(traffic, config, 11, "cpu")


@pytest.fixture(params=[2, 3], ids=["2_views", "3_views"])
def tiny(request):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield _tiny(request.param)
    torch.set_num_threads(threads)


def _context(wrapper, unit):
    from pixelsplat_tpu_torch.training.model_wrapper import batch_to

    return wrapper.data_shim(batch_to(unit.batch, "cpu"))["context"]


def _equal(a, b) -> bool:
    return type(a) is type(b) and all(
        (x is None and y is None) or (x.shape == y.shape and torch.equal(x, y)) for x, y in zip(a, b)
    )


def _encode(encoder, context, eager=False, **kw):
    with torch.no_grad():
        return encoder(context, 0, False, visualization_dump={} if eager else None, **kw)


@pytest.mark.parametrize("pack_soa", [True, False], ids=["soa", "aos"])
def test_emulated_graphs_replay_each_scene_as_eager(tiny, emulated, pack_soa):
    wrapper, units = tiny
    encoder = wrapper.encoder
    contexts = [_context(wrapper, unit) for unit in units]
    eager = [_encode(encoder, c, True, pack_soa=pack_soa, u=unit.u, view_order=unit.view_order)
             for c, unit in zip(contexts, units)]
    assert tracing.counter("encoder_graph_scenes") == 0
    first = _encode(encoder, contexts[0], pack_soa=pack_soa, u=units[0].u, view_order=units[0].view_order)
    kept = copy.deepcopy(first)
    second = _encode(encoder, contexts[1], pack_soa=pack_soa, u=units[1].u, view_order=units[1].view_order)
    assert _equal(first, eager[0]) and _equal(second, eager[1])
    assert _equal(first, kept)  # the second replay left the first scene's planes alone
    assert tracing.counter("encoder_graph_captures") == 1 and tracing.counter("encoder_graph_scenes") == 2


def test_emulated_graphs_draw_from_the_generator_as_eager(tiny, emulated):
    wrapper, units = tiny
    context = _context(wrapper, units[0])
    g_eager, g_graph = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for _ in range(2):  # a capture, then a replay
        eager = _encode(wrapper.encoder, context, True, pack_soa=True, generator=g_eager)
        graphed = _encode(wrapper.encoder, context, pack_soa=True, generator=g_graph)
        assert _equal(graphed, eager)
    assert torch.equal(g_eager.get_state(), g_graph.get_state())
    assert tracing.counter("encoder_graph_scenes") == 2


def test_emulated_graphs_capture_again_for_a_new_signature_or_replaced_weights(tiny, emulated):
    wrapper, units = tiny
    encoder = wrapper.encoder
    context, unit = _context(wrapper, units[0]), units[0]
    _encode(encoder, context, pack_soa=True, u=unit.u, view_order=unit.view_order)
    _encode(encoder, context, pack_soa=False, u=unit.u, view_order=unit.view_order)
    with torch.no_grad():
        encoder(context, 0, True, pack_soa=True)  # deterministic: one Gaussian a pixel, no draws
    assert tracing.counter("encoder_graph_captures") == 3

    head = encoder.to_gaussians[1]
    weight = head.weight
    try:
        with torch.no_grad():
            head.weight.mul_(1.5)  # in place: the graphs read it
        graphed = _encode(encoder, context, pack_soa=True, u=unit.u, view_order=unit.view_order)
        assert tracing.counter("encoder_graph_captures") == 3
        assert _equal(graphed, _encode(encoder, context, True, pack_soa=True, u=unit.u, view_order=unit.view_order))

        head.weight = torch.nn.Parameter(weight.detach() * 0.5)  # a new tensor: captured again
        graphed = _encode(encoder, context, pack_soa=True, u=unit.u, view_order=unit.view_order)
        assert tracing.counter("encoder_graph_captures") == 4
        assert _equal(graphed, _encode(encoder, context, True, pack_soa=True, u=unit.u, view_order=unit.view_order))
    finally:
        with torch.no_grad():
            weight.div_(1.5)
        head.weight = weight


def test_emulated_graphs_stay_out_of_autograd_dumps_and_intermediates(tiny, emulated):
    wrapper, units = tiny
    encoder, context, unit = wrapper.encoder, _context(wrapper, units[0]), units[0]
    kw = dict(pack_soa=True, u=unit.u, view_order=unit.view_order)
    out = encoder(context, 0, False, **kw)  # grad enabled
    assert out.mean_x.requires_grad
    _encode(encoder, context, True, **kw)  # a visualization dump
    with torch.no_grad(), encoder.capture_intermediates() as captured:
        encoder(context, 0, False, **kw)
    assert captured["pdf"] is not None
    assert tracing.counter("encoder_graph_scenes") == 0 and tracing.counter("encoder_graph_captures") == 0


def test_emulated_replays_record_spans_and_launches_as_eager(tiny, emulated):
    wrapper, units = tiny
    encoder, context, unit = wrapper.encoder, _context(wrapper, units[0]), units[0]
    kw = dict(pack_soa=True, u=unit.u, view_order=unit.view_order)
    _encode(encoder, context, **kw)  # capture
    tracing.reset()
    tracing.enable(True)
    _encode(encoder, context, True, **kw)
    eager = tracing.read()
    tracing.reset()
    _encode(encoder, context, **kw)
    graphed = tracing.read()
    calls = lambda got: {k: v["calls"] for k, v in got["spans"].items()}  # noqa: E731
    assert calls(graphed) == calls(eager) == {f"encoder.{s}": 1 for s in ("backbone", "epipolar", "refine", "heads")}
    assert graphed["counters"]["gaussians"] == eager["counters"]["gaussians"]
    assert graphed["counters"]["encoder_graph_scenes.traced"] == 1 and "host_syncs" not in graphed["counters"]


def _tiny_costvolume(views: int):
    from benchmark import generator, port

    config = json.loads((ROOT / "benchmark" / "configs" / "mvsplat.json").read_text())
    config["image_shape"] = [64, 64]
    config["encoder"].update(d_feature=32, num_depth_candidates=8, costvolume_unet_feat_dim=16, depth_unet_feat_dim=8,
                             num_context_views=views)
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "eval.json").read_text())
    traffic.update(pool=2)
    return port.build(config, 13, "cpu"), generator.make_units(traffic, config, 13, "cpu")


@pytest.mark.parametrize("views", [2, 3])
def test_emulated_graphs_replay_the_cost_volume_encoder_as_eager(emulated, views):
    """MVSplat's six stages through the same graph code: each scene's
    replay equals its eager encode, with each stage's span."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        wrapper, units = _tiny_costvolume(views)
        encoder = wrapper.encoder
        contexts = [_context(wrapper, unit) for unit in units]
        eager = [_encode(encoder, c, True, pack_soa=True) for c in contexts]
        tracing.enable(True)
        graphed = [_encode(encoder, c, pack_soa=True) for c in contexts]
        assert all(_equal(g, e) for g, e in zip(graphed, eager))
        stages = ("backbone", "mv_transformer", "costvolume", "cv_refine", "depth_refine", "heads")
        assert {k: v["calls"] for k, v in tracing.read()["spans"].items() if k.startswith("encoder.")} == {
            f"encoder.{s}": 2 for s in stages
        }
        assert tracing.counter("encoder_graph_captures") == 1 and tracing.counter("encoder_graph_scenes") == 2
    finally:
        torch.set_num_threads(threads)


def test_emulated_graphs_replay_the_gslrm_encoder_as_eager(emulated):
    """GS-LRM's three stages through the same graph code: each scene's
    replay equals its eager encode, with each stage's span."""
    from benchmark import generator, port

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        config = json.loads((ROOT / "benchmark" / "configs" / "gslrm.json").read_text())
        config["image_shape"] = [32, 32]
        config["encoder"].update(depth=2, d_model=64, heads=4)
        traffic = json.loads((ROOT / "benchmark" / "traffic" / "eval.json").read_text())
        traffic.update(pool=2)
        wrapper = port.build(config, 13, "cpu")
        encoder = wrapper.encoder
        contexts = [_context(wrapper, unit) for unit in generator.make_units(traffic, config, 13, "cpu")]
        eager = [_encode(encoder, c, True, pack_soa=True) for c in contexts]
        tracing.enable(True)
        graphed = [_encode(encoder, c, pack_soa=True) for c in contexts]
        assert all(_equal(g, e) for g, e in zip(graphed, eager))
        assert {k: v["calls"] for k, v in tracing.read()["spans"].items() if k.startswith("encoder.")} == {
            f"encoder.{s}": 2 for s in ("backbone", "transformer", "heads")
        }
        assert tracing.counter("encoder_graph_captures") == 1 and tracing.counter("encoder_graph_scenes") == 2
    finally:
        torch.set_num_threads(threads)


# On the card: the real graphs against the eager encode.


CARD_SEED = 2**31 + 17


@pytest.fixture(scope="module", params=["re10k.eval", "re10k_3_view.eval"])
def card(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark import generator, port, spec
    from pixelsplat_tpu_torch.training.model_wrapper import batch_to

    cell = spec.load_cell(request.param)
    port.set_precision(cell.config)
    wrapper = port.build(cell.config, CARD_SEED, "cuda")
    units = generator.make_units({**cell.traffic, "pool": 2}, cell.config, CARD_SEED, "cuda")
    contexts = [wrapper.data_shim(batch_to(u.batch, "cuda"))["context"] for u in units]
    return wrapper.encoder, units, contexts


def _card_encode(encoder, context, eager=False, **kw):
    with torch.no_grad():
        out = encoder(context, 0, False, visualization_dump={} if eager else None, **kw)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("pack_soa", [True, False], ids=["soa", "aos"])
def test_card_graphs_equal_eager_scene_by_scene(card, pack_soa):
    encoder, units, contexts = card
    kw = [dict(pack_soa=pack_soa, u=u.u, view_order=u.view_order) for u in units]
    eager = [_card_encode(encoder, c, True, **k) for c, k in zip(contexts, kw)]
    assert tracing.counter("linear_split_launches") == 2 * 48  # the ViT's layers ran as K10 eagerly too
    first = _card_encode(encoder, contexts[0], **kw[0])
    kept = _clone(first)
    second = _card_encode(encoder, contexts[1], **kw[1])
    assert _equal(first, eager[0]) and _equal(second, eager[1])
    assert _equal(first, kept)  # the second encode left the first scene's planes alone
    assert tracing.counter("encoder_graph_scenes") == 2


def _clone(gaussians):
    return type(gaussians)(*(None if t is None else t.clone() for t in gaussians))


@pytest.mark.cuda
def test_card_graphs_draw_from_the_generator_as_eager(card):
    encoder, _, contexts = card
    g_eager = torch.Generator(device="cuda").manual_seed(9)
    g_graph = torch.Generator(device="cuda").manual_seed(9)
    for _ in range(2):
        eager = _card_encode(encoder, contexts[0], True, pack_soa=True, generator=g_eager)
        graphed = _card_encode(encoder, contexts[0], pack_soa=True, generator=g_graph)
        assert _equal(graphed, eager)
    assert torch.equal(g_eager.get_state(), g_graph.get_state())


@pytest.mark.cuda
def test_card_graphs_capture_again_for_a_new_signature_or_replaced_weights(card):
    encoder, units, contexts = card
    kw = dict(pack_soa=True, u=units[0].u, view_order=units[0].view_order)
    _card_encode(encoder, contexts[0], **kw)
    before = tracing.counter("encoder_graph_captures")
    with torch.no_grad():
        deterministic = encoder(contexts[0], 0, True, pack_soa=True)
        want = encoder(contexts[0], 0, True, pack_soa=True, visualization_dump={})
    assert tracing.counter("encoder_graph_captures") == before + 1 and _equal(deterministic, want)

    head = encoder.to_gaussians[1]
    weight = head.weight
    try:
        head.weight = torch.nn.Parameter(weight.detach() * 0.5)
        graphed = _card_encode(encoder, contexts[0], **kw)
        assert tracing.counter("encoder_graph_captures") == before + 2
        assert _equal(graphed, _card_encode(encoder, contexts[0], True, **kw))
    finally:
        head.weight = weight


@pytest.mark.cuda
def test_card_eager_under_autograd_dumps_and_intermediates(card):
    encoder, units, contexts = card
    kw = dict(pack_soa=True, u=units[0].u, view_order=units[0].view_order)
    _card_encode(encoder, contexts[0], **kw)
    scenes = tracing.counter("encoder_graph_scenes")
    out = encoder(contexts[0], 0, False, **kw)
    assert out.mean_x.requires_grad
    del out
    _card_encode(encoder, contexts[0], True, **kw)
    with torch.no_grad(), encoder.capture_intermediates() as captured:
        encoder(contexts[0], 0, False, **kw)
    assert captured["pdf"] is not None and tracing.counter("encoder_graph_scenes") == scenes


@pytest.mark.cuda
def test_card_replays_count_k9_and_never_sync(card):
    encoder, units, contexts = card
    kw = dict(pack_soa=True, u=units[1].u, view_order=units[1].view_order)
    _card_encode(encoder, contexts[1], **kw)
    tracing.reset()
    tracing.enable(True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            encoder(contexts[1], 0, False, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        tracing.enable(False)
    got = tracing.read()
    assert got["counters"]["conv7_launches"] == 2 and got["counters"]["encoder_graph_scenes"] == 1
    assert got["counters"]["linear_split_launches"] == 48  # 4 layers of 12 blocks, all views in one launch
    assert "host_syncs" not in got["counters"], tracing.table(got)
    assert {k for k in got["spans"]} == {f"encoder.{s}" for s in ("backbone", "epipolar", "refine", "heads")}
