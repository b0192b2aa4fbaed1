"""MVSplat's stride-1 3x3 convolutions (`ops/conv3x3_kernel.py`, K11 in
`csrc/conv3x3.cu`): the split-precision twin at every distinct shape of an
`mvsplat` scene, which convolutions K11 takes, the `Conv3x3` module the
encoder builds them with, the gradient, and on the card the kernel against
float64 and the encoder's launches.

The encoder's parity with the plain reference, on the CPU, where every
convolution takes `nn.Conv2d`'s own route as before K11, is
`test_torch_encoder_costvolume.py`. The card tests (marked `cuda`) import
nothing of the JAX package; run them on the card with

    python -m pytest tests/test_torch_conv3x3.py -m cuda --noconftest -p no:cacheprovider
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from benchmark import weights as wts
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.model.encoder.encoder_costvolume import EncoderCostVolume
from pixelsplat_tpu_torch.ops import conv3x3_kernel
from pixelsplat_tpu_torch.scripts import bench_conv3x3
from pixelsplat_tpu_torch.utils import tracing

# The distinct (c_in, c_out, h, w, GELU) of the 87 convolutions K11 runs in
# an `mvsplat` evaluation scene (2 views at 256x256, batch 2 each).
SHAPES = [
    (32, 32, 16, 16, False), (32, 32, 32, 32, False), (32, 32, 64, 64, False), (32, 32, 128, 128, False),
    (32, 32, 256, 256, False), (32, 64, 256, 256, True), (37, 32, 256, 256, False), (64, 32, 16, 16, False),
    (64, 32, 32, 32, False), (64, 32, 64, 64, False), (64, 32, 128, 128, False), (64, 32, 256, 256, False),
    (64, 64, 128, 128, False), (96, 96, 64, 64, False), (96, 128, 64, 64, False), (128, 32, 256, 256, False),
    (128, 128, 16, 16, False), (128, 128, 32, 32, False), (128, 128, 64, 64, False), (128, 256, 64, 64, True),
    (163, 168, 256, 256, True), (168, 84, 256, 256, False), (256, 128, 16, 16, False), (256, 128, 32, 32, False),
    (256, 128, 64, 64, False),
]
SHAPE_IDS = [f"{ci}-{co}-{h}x{w}{'-gelu' if g else ''}" for ci, co, h, w, g in SHAPES]
# On the CPU the twin is held at each shape's channels over at most a
# 24 x 24 crop of its image: the split's error follows K = 9 c_in and not
# the image's size, and the full images would take minutes on one thread.
CROP = 24
# Relative RMS error against float64: the twin and plain float32 both read
# 1e-7 to 4e-7 at these shapes, plain TF32 (10 mantissa bits) 1e-4 or more.
TWIN_RTOL = 2e-6


@pytest.fixture(autouse=True)
def one_thread_and_fresh_counters():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.reset()
    yield
    torch.set_num_threads(threads)
    tracing.reset()


def features(shape, seed=1, device="cpu"):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device)


def conv_params(c_in, c_out, seed=2, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    weight = torch.randn((c_out, c_in, 3, 3), generator=g) / (9 * c_in) ** 0.5
    bias = 0.1 * torch.randn((c_out,), generator=g)
    return weight.to(device), bias.to(device)


def rel_rms(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def f64(x, weight, bias, gelu=False):
    z = F.conv2d(x.double(), weight.double(), None if bias is None else bias.double(), padding=1)
    return F.gelu(z) if gelu else z


def test_scene_shapes_are_the_encoders():
    convs = bench_conv3x3.scene_convolutions()
    assert len(convs) == 87
    assert sum(map(bench_conv3x3.flops, convs)) == 227_379_511_296
    assert sorted({(c["c_in"], c["c_out"], c["h"], c["w"], c["gelu"]) for c in convs}) == sorted(SHAPES)
    assert {c["n"] for c in convs} == {2}


@pytest.mark.parametrize("c_in, c_out, h, w, gelu", SHAPES, ids=SHAPE_IDS)
def test_split_twin_holds_float32_and_plain_tf32_does_not(c_in, c_out, h, w, gelu):
    weight, bias = conv_params(c_in, c_out)
    x = features((1, c_in, min(h, CROP), min(w, CROP)))
    with torch.no_grad():
        want = f64(x, weight, bias)
        split = conv3x3_kernel.conv3x3_split_plain(x, weight, bias)
        tf32 = conv3x3_kernel.conv3x3_split_plain(x, weight, bias, terms=1)
        if gelu:
            assert torch.equal(conv3x3_kernel.conv3x3_split_plain(x, weight, bias, gelu=True), F.gelu(split))
    assert rel_rms(split, want) <= TWIN_RTOL
    assert rel_rms(tf32, want) > 10 * TWIN_RTOL


def fake_cuda(c_in, dtype=torch.float32):
    """What `takes` reads of an input, as a CUDA tensor would give it."""
    return SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype, dim=lambda: 4, shape=(2, c_in, 16, 16))


REFUSED = {
    "stride2": dict(conv=lambda: conv3x3_kernel.Conv3x3(32, 32, stride=2)),
    "1x1": dict(conv=lambda: nn.Conv2d(32, 32, 1)),
    "7x7": dict(conv=lambda: nn.Conv2d(32, 32, 7, 1, 3)),
    "dilation": dict(conv=lambda: nn.Conv2d(32, 32, 3, 1, 2, dilation=2)),
    "groups": dict(conv=lambda: nn.Conv2d(32, 32, 3, 1, 1, groups=2)),
    "pad0": dict(conv=lambda: nn.Conv2d(32, 32, 3, 1, 0)),
    "reflect": dict(conv=lambda: nn.Conv2d(32, 32, 3, 1, 1, padding_mode="reflect")),
    "cout2": dict(conv=lambda: conv3x3_kernel.Conv3x3(32, 2)),
    "cout7": dict(conv=lambda: conv3x3_kernel.Conv3x3(32, 7)),
    "cpu": dict(x=lambda: torch.zeros(2, 32, 16, 16)),
    "float64_input": dict(x=lambda: fake_cuda(32, torch.float64)),
    "bfloat16_input": dict(x=lambda: fake_cuda(32, torch.bfloat16)),
    "float64_weight": dict(conv=lambda: conv3x3_kernel.Conv3x3(32, 32).double()),
    "bf16_policy": dict(conv=lambda: SimpleNamespace(**vars(conv3x3_kernel.Conv3x3(32, 32)), **{
        "compute_dtype": torch.bfloat16, "weight": torch.zeros(32, 32, 3, 3), "bias": torch.zeros(32)})),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_takes_refuses_what_k11_does_not_compute(case):
    spec = REFUSED[case]
    conv = spec.get("conv", lambda: conv3x3_kernel.Conv3x3(32, 32))()
    x = spec.get("x", lambda: fake_cuda(32))()
    assert not conv3x3_kernel.takes(x, conv)


@pytest.mark.parametrize("c_in, c_out, bias", [(37, 32, True), (163, 168, True), (64, 8, True), (96, 96, False),
                                              (256, 300, True)])
def test_takes_cuda_float32_3x3_stride1(c_in, c_out, bias):
    conv = conv3x3_kernel.Conv3x3(c_in, c_out, bias=bias)
    assert conv3x3_kernel.takes(fake_cuda(c_in), conv)
    assert conv3x3_kernel.takes(fake_cuda(c_in), nn.Conv2d(c_in, c_out, 3, 1, 1, bias=bias))


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_cpu_takes_the_plain_route_bit_for_bit(gelu, bias):
    torch.manual_seed(3)
    conv = conv3x3_kernel.Conv3x3(12, 20, bias=bias, gelu=gelu)
    plain = nn.Conv2d(12, 20, 3, 1, 1, bias=bias)
    plain.load_state_dict(conv.state_dict(), strict=True)
    seq = nn.Sequential(plain, nn.GELU()) if gelu else plain
    x = features((2, 12, 9, 11))
    with torch.no_grad():
        assert torch.equal(conv(x), seq(x))
    assert not conv3x3_kernel.takes(x, conv)
    assert tracing.counter("conv3x3_launches") == 0


def test_launch_refuses_what_the_kernel_does_not_take():
    weight, bias = conv_params(16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_kernel.launch(features((1, 16, 8, 8)), weight, bias)
    assert tracing.counter("conv3x3_launches") == 0


def test_encoder_state_dict_is_unchanged_and_loads_the_benchmarks_weights():
    """Every 3x3 convolution of the encoder is a `Conv3x3`, 87 of them K11's
    at the published widths, under `nn.Conv2d`'s names; the GELUs K11 applies
    leave an `nn.Identity` in their place."""
    with torch.device("meta"):
        encoder = EncoderCostVolume(pt_config.mvsplat()[0])
    convs = {name: m for name, m in encoder.named_modules() if isinstance(m, nn.Conv2d) and m.kernel_size == (3, 3)}
    assert all(isinstance(m, conv3x3_kernel.Conv3x3) for m in convs.values())
    assert sum(conv3x3_kernel.computes(m) for m in convs.values()) == 87
    fused = sorted(name for name, m in convs.items() if m.gelu)
    assert fused == ["depth_predictor.depth_head_lowres.0", "depth_predictor.to_disparity.0",
                     "depth_predictor.to_gaussians.0"]
    for name in fused:
        parent = encoder.get_submodule(name.rsplit(".", 1)[0])
        assert isinstance(parent[1], nn.Identity) and not list(parent[1].parameters())
    keys = set(encoder.state_dict())
    for name, m in convs.items():
        assert f"{name}.weight" in keys and (m.bias is None) == (f"{name}.bias" not in keys)

    from benchmark.reference import costvolume as ref

    cfg = dataclasses.replace(pt_config.mvsplat()[0], d_feature=32, num_depth_candidates=8,
                              costvolume_unet_feat_dim=16, depth_unet_feat_dim=8)
    program = EncoderCostVolume(cfg)
    reference = ref.Encoder(dataclasses.asdict(cfg))
    assert set(program.state_dict()) == set(reference.state_dict())
    state = wts.encoder_weights(wts.shapes_of(program), 2**31 + 5, "cpu")
    program.load_state_dict(state, strict=True)
    assert torch.equal(program.depth_predictor.to_gaussians[2].weight, state["depth_predictor.to_gaussians.2.weight"])


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_autograd_function_matches_conv2d(monkeypatch, gelu, bias):
    """`Conv3x3Split`'s plain backward, its forward's launch played by the
    twin on the CPU."""
    monkeypatch.setattr(conv3x3_kernel, "launch", conv3x3_kernel.conv3x3_split_plain)
    torch.manual_seed(4)
    conv = nn.Conv2d(10, 16, 3, 1, 1, bias=bias)
    x = features((2, 10, 7, 9), seed=5).requires_grad_()
    cot = features((2, 16, 7, 9), seed=6)
    out = conv3x3_kernel.Conv3x3Split.apply(x, conv.weight, conv.bias, gelu)
    got = torch.autograd.grad((out * cot).sum(), (x, *conv.parameters()))
    want_out = F.gelu(conv(x)) if gelu else conv(x)
    want = torch.autograd.grad((want_out * cot).sum(), (x, *conv.parameters()))
    assert rel_rms(out, want_out) < 1e-6
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_rms(g, w) < 1e-5


# On the card.


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("gelu", [False, True], ids=["plain", "gelu"])
@pytest.mark.parametrize("c_in, c_out, h, w, _gelu", SHAPES, ids=SHAPE_IDS)
def test_k11_is_within_twice_cudnn_float32_error_and_plain_tf32_is_not(c_in, c_out, h, w, _gelu, gelu):
    _card()
    weight, bias = conv_params(c_in, c_out, device="cuda")
    x = features((2, c_in, h, w), seed=7, device="cuda")
    with torch.no_grad():
        want = f64(x, weight, bias, gelu)
        k11 = conv3x3_kernel.launch(x, weight, bias, gelu)
        tf32 = conv3x3_kernel.launch(x, weight, bias, gelu, terms=1)
        z = F.conv2d(x, weight, bias, padding=1)
        cudnn = F.gelu(z) if gelu else z
    torch.cuda.synchronize()
    e_k11, e_tf32, e_cudnn = (rel_rms(t, want) for t in (k11, tf32, cudnn))
    print(f"{c_in}->{c_out} {h}x{w}{' gelu' if gelu else ''}: relative RMS error against float64: K11 {e_k11:.3g}, "
          f"TF32 {e_tf32:.3g}, cuDNN float32 {e_cudnn:.3g}")
    assert e_k11 <= 2 * e_cudnn
    assert e_tf32 > 2 * e_cudnn


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 37, 8, 13, 21), (2, 163, 168, 19, 35), (1, 8, 8, 5, 7), (2, 40, 300, 9, 17),
                                   (1, 168, 84, 33, 16), (3, 96, 96, 6, 40)])
def test_k11_matches_its_plain_twin(shape):
    """Ragged tiles and channel tails, c_out split over blocks, no bias."""
    _card()
    n, c_in, c_out, h, w = shape
    weight, bias = conv_params(c_in, c_out, seed=9, device="cuda")
    x = features((n, c_in, h, w), seed=10, device="cuda")
    for gelu, b in ((True, bias), (False, bias), (False, None)):
        with torch.no_grad():
            out = conv3x3_kernel.launch(x, weight, b, gelu)
            want = conv3x3_kernel.conv3x3_split_plain(x, weight, b, gelu)
        assert rel_rms(out, want) < 1e-6
    assert tracing.counter("conv3x3_launches") == 3


@pytest.mark.cuda
def test_k11_sees_an_in_place_weight_update():
    _card()
    torch.manual_seed(15)
    conv = conv3x3_kernel.Conv3x3(16, 64).cuda()
    x = features((1, 16, 8, 16), seed=16, device="cuda")
    with torch.no_grad():
        before = conv(x)
        conv.weight.mul_(-0.5)
        after = conv(x)
        want = conv3x3_kernel.conv3x3_split_plain(x, conv.weight, conv.bias)
    assert rel_rms(after, want) < 1e-6
    assert rel_rms(before, want) > 0.5
    assert tracing.counter("conv3x3_launches") == 2


@pytest.mark.cuda
def test_module_on_the_card_routes_and_differentiates():
    _card()
    torch.manual_seed(12)
    conv = conv3x3_kernel.Conv3x3(24, 40, gelu=True).cuda()
    x = features((2, 24, 20, 30), seed=13, device="cuda")
    with torch.no_grad():
        out = conv(x)
        want = F.gelu(nn.Conv2d.forward(conv, x))
    assert tracing.counter("conv3x3_launches") == 1
    assert rel_rms(out, want) < 1e-5
    xg = x.clone().requires_grad_()
    cot = features(out.shape, seed=14, device="cuda")
    got = torch.autograd.grad((conv(xg) * cot).sum(), (xg, *conv.parameters()))
    assert tracing.counter("conv3x3_launches") == 2
    want_out = F.gelu(nn.Conv2d.forward(conv, xg))
    wants = torch.autograd.grad((want_out * cot).sum(), (xg, *conv.parameters()))
    for g, w in zip(got, wants):
        assert rel_rms(g, w) < 1e-5
    stride2 = conv3x3_kernel.Conv3x3(24, 40, stride=2).cuda()
    with torch.no_grad():
        stride2(x)
    assert tracing.counter("conv3x3_launches") == 2


@pytest.mark.cuda
def test_an_mvsplat_scene_launches_k11_87_times_and_graphs_equal_eager():
    """At the cell's widths: an eager encode (the visualization dump keeps it
    off the graphs) and two graphed ones, each 87 launches, the graphed
    Gaussians equal to the eager ones element for element."""
    _card()
    from benchmark import generator, port, spec
    from pixelsplat_tpu_torch.training.model_wrapper import batch_to

    cell = spec.load_cell("mvsplat.eval")
    port.set_precision(cell.config)
    wrapper = port.build(cell.config, 2**31 + 23, "cuda")
    unit = generator.make_units({**cell.traffic, "pool": 1}, cell.config, 2**31 + 23, "cuda")[0]
    ctx = wrapper.data_shim(batch_to(unit.batch, "cuda"))["context"]
    counts = []
    with torch.no_grad():
        tracing.reset()
        eager = wrapper.encoder(ctx, 0, False, pack_soa=True, visualization_dump={})
        counts.append(tracing.counter("conv3x3_launches"))
        for _ in range(2):
            tracing.reset()
            graphed = wrapper.encoder(ctx, 0, False, pack_soa=True)
            counts.append(tracing.counter("conv3x3_launches"))
    torch.cuda.synchronize()
    assert counts == [87, 87, 87]
    assert all(x is None and y is None or torch.equal(x, y) for x, y in zip(graphed, eager))


def test_an_mvsplat_scene_builds_k11_with_the_render_and_not_k9_or_k10(monkeypatch, tmp_path):
    """K11's first load builds projection, binning and K1 beside it; a
    source built already then loads without building its group, so the
    render's loads build neither K9 nor K10."""
    from pixelsplat_tpu_torch import kernel_build

    built = []

    def build_many(names):
        built.append(tuple(names))
        for name in names:
            kernel_build.library_path(name).touch()

    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel_build, "build_many", build_many)
    monkeypatch.setattr(kernel_build, "build", lambda name, csrc=None: (kernel_build.library_path(name), ""))
    monkeypatch.setattr(kernel_build.ctypes, "CDLL", lambda path: Path(path).name.split("-")[0])
    monkeypatch.setattr(kernel_build, "_loaded", {})
    for name in ("conv3x3", "project_bin", "composite_fwd", "conv3x3"):
        assert kernel_build.load(name) == f"lib{name}"
    assert built == [("conv3x3", "composite_fwd", "project_bin")]
