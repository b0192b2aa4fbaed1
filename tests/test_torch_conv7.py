"""The refinement's two 7x7 convolutions (`ops/conv7_kernel.py`, K9 in
`csrc/conv7.cu`): the split-precision twin, which version a call runs, the
weight repack and its cache, the gradient, and on the card the kernel
against a float64 convolution.

The JAX package's parity tests that cover the refinement are
`test_torch_epipolar.py::test_epipolar_transformer*`, on the CPU, where the
refinement takes the same plain float32 route as before K9. The card tests
(marked `cuda`) import nothing of the JAX package; run them on the card with

    python -m pytest tests/test_torch_conv7.py -m cuda --noconftest -p no:cacheprovider
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from pixelsplat_tpu_torch.model import precision
from pixelsplat_tpu_torch.model.encoder.epipolar import epipolar_transformer as pt_et
from pixelsplat_tpu_torch.ops import conv7_kernel
from pixelsplat_tpu_torch.utils import tracing

# Relative RMS error of the split twin against plain float32 on the CPU
# (its error over the RMS of the convolution's own term). Against float64
# both read 4.5e-7 at these sizes, so their difference reads 6.4e-7; plain
# TF32 keeps 10 mantissa bits and reads 2.9e-4.
TWIN_RTOL = 2e-6


@pytest.fixture(autouse=True)
def one_thread_and_fresh_counters():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.reset()
    yield
    torch.set_num_threads(threads)
    tracing.reset()


def convs(c=16, seed=0, dtype=None):
    """conv1 (c -> 2c) and conv2 (2c -> c) as the encoder builds them, with
    their default initialisation from `seed`."""
    torch.manual_seed(seed)
    return (precision.Conv2d(c, 2 * c, 7, 1, 3, compute_dtype=dtype),
            precision.Conv2d(2 * c, c, 7, 1, 3, compute_dtype=dtype))


def features(shape, seed=1, device="cpu"):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device)


def rel_rms(got, want, base):
    """RMS of got - want over the RMS of the convolution's term want - base."""
    return float((got.double() - want.double()).pow(2).mean().sqrt() / (want.double() - base).pow(2).mean().sqrt())


def plain_f32(x, conv, gelu, residual):
    z = conv7_kernel._conv_plain(x, conv.weight, conv.bias)
    z = F.gelu(z) if gelu else z
    return z if residual is None else residual + z


@pytest.mark.parametrize("which", ["conv1_gelu", "conv2_residual"])
def test_split_twin_holds_float32_and_plain_tf32_does_not(which):
    conv1, conv2 = convs()
    x = features((2, 11, 13, 16))
    with torch.no_grad():
        if which == "conv1_gelu":  # held before the GELU, on the convolution's own term
            inp, conv, residual = x, conv1, None
            assert torch.equal(conv7_kernel.conv7_split_plain(x, conv.weight, conv.bias, gelu=True),
                               F.gelu(conv7_kernel.conv7_split_plain(x, conv.weight, conv.bias)))
        else:
            inp, conv, residual = F.gelu(conv7_kernel._conv_plain(x, conv1.weight, conv1.bias)), conv2, x
        want = plain_f32(inp, conv, False, residual)
        base = 0.0 if residual is None else residual.double()
        split = conv7_kernel.conv7_split_plain(inp, conv.weight, conv.bias, residual=residual)
        tf32 = conv7_kernel.conv7_split_plain(inp, conv.weight, conv.bias, residual=residual, terms=1)
    assert rel_rms(split, want, base) <= TWIN_RTOL
    assert rel_rms(tf32, want, base) > 10 * TWIN_RTOL


def test_tf32_split_parts():
    x = features((4096,), seed=3) * 1e3
    hi, lo = conv7_kernel.tf32_split(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())  # 10 mantissa bits
    # hi is x to nearest in TF32; lo holds the rest to 2^-11 of itself.
    assert bool(((x - hi).abs() <= hi.abs() * 2.0**-11).all())
    assert bool(((x - hi - lo).abs() <= (x - hi).abs() * 2.0**-11).all())
    assert torch.equal(conv7_kernel.tf32_split(torch.tensor([1.0, -2.5, 0.0]))[0], torch.tensor([1.0, -2.5, 0.0]))


def test_cpu_takes_the_plain_route_bit_for_bit():
    conv1, conv2 = convs()
    x = features((3, 9, 10, 16))
    seq = nn.Sequential(conv1, nn.GELU(), conv2)
    with torch.no_grad():
        got = conv7_kernel.refine(x, conv1, conv2)
        want = x + pt_et.conv_nhwc(seq, x)
    assert torch.equal(got, want)
    assert not conv7_kernel.takes(x, conv1, conv2)
    assert tracing.counter("conv7_launches") == 0


def test_bf16_policy_keeps_precision_conv2d():
    conv1, conv2 = convs(dtype=torch.bfloat16)
    x = features((1, 8, 8, 16))
    seen = []
    for conv in (conv1, conv2):
        conv.register_forward_hook(lambda _m, _i, out: seen.append(out.dtype))
    with torch.no_grad():
        out = conv7_kernel.refine(x, conv1, conv2)
    assert seen == [torch.bfloat16, torch.bfloat16]
    assert out.dtype == torch.float32  # the residual promotes, as before
    assert tracing.counter("conv7_launches") == 0


def test_epipolar_transformer_refines_through_refine():
    cfg = pt_et.EpipolarTransformerCfg(num_layers=1, num_heads=2, d_dot=16, d_mlp=16, num_samples=4)
    module = pt_et.EpipolarTransformer(cfg, 16)
    calls = []
    original = conv7_kernel.refine

    def spy(x, conv1, conv2):
        calls.append((tuple(x.shape), conv1 is module.upscale_refinement[0], conv2 is module.upscale_refinement[2]))
        return original(x, conv1, conv2)

    conv7_kernel.refine = spy
    try:
        v = 2
        extr = torch.eye(4).repeat(1, v, 1, 1)
        extr[:, :, 0, 3] = torch.linspace(0, 1, v)
        intr = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]).repeat(1, v, 1, 1)
        with torch.no_grad():
            out, _ = module(features((1, v, 16, 16, 16)), extr, intr, torch.ones(1, v), torch.full((1, v), 10.0))
    finally:
        conv7_kernel.refine = original
    assert calls == [((2, 16, 16, 16), True, True)]
    assert out.shape == (1, v, 16, 16, 16)


def fragments(weight):
    """The packed weights entry by entry: block of 16 output channels ob,
    of 16 input channels c, tap, k8 step s, lane 4 g + t, register e holds
    weight[16 ob + 8 (e % 2) + g, 16 c + 8 s + 4 (e // 2) + t, tap]."""
    c_out, c_in = weight.shape[:2]
    out = torch.empty((c_out // 16, c_in // 16, 49, 2, 32, 4))
    w = weight.detach().reshape(c_out, c_in, 49)
    for ob in range(c_out // 16):
        for c in range(c_in // 16):
            for s in range(2):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for e in range(4):
                        out[ob, c, :, s, lane, e] = w[16 * ob + 8 * (e % 2) + g, 16 * c + 8 * s + 4 * (e // 2) + t]
    return out


def test_weight_repack_follows_updates():
    conv1, _ = convs()
    w = conv1.weight
    packed = conv7_kernel.pack_weight(w)
    assert packed.shape == (2, 1, 49, 2, 32, 4) and packed.is_contiguous()
    assert torch.equal(packed, fragments(w))
    with torch.no_grad():
        w.mul_(2.0)  # an optimizer's in-place step: the next pack sees it
    assert torch.equal(conv7_kernel.pack_weight(w), fragments(w))
    assert torch.equal(conv7_kernel.pack_weight(w), 2.0 * packed)


def test_autograd_function_matches_sequential():
    conv1, conv2 = convs(seed=4)
    seq = nn.Sequential(conv1, nn.GELU(), conv2)
    x = features((2, 9, 11, 16), seed=5).requires_grad_()
    cot = features((2, 9, 11, 16), seed=6)

    out = conv7_kernel.Conv7Refine.apply(x, conv1.weight, conv1.bias, conv2.weight, conv2.bias)
    got = torch.autograd.grad((out * cot).sum(), (x, *seq.parameters()))
    want_out = x + seq(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = torch.autograd.grad((want_out * cot).sum(), (x, *seq.parameters()))
    assert torch.allclose(out, want_out, rtol=1e-5, atol=1e-6)
    for name, g, w in zip(("x", "w1", "b1", "w2", "b2"), got, want):
        assert g.shape == w.shape, name
        assert rel_rms(g, w, 0.0) < 1e-5, name


def test_launch_refuses_shapes_the_kernel_does_not_take():
    conv1, _ = convs(c=16)
    with pytest.raises(ValueError):
        conv7_kernel.launch(features((1, 4, 4, 16)), conv1.weight, conv1.bias)  # a CPU tensor
    assert tracing.counter("conv7_launches") == 0


# On the card.

SCENES = {"re10k": 2, "re10k_3_view": 3}  # context views, each 256x256 at d_feature 128


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f64(x, conv, gelu, residual):
    z = F.conv2d(x.double().permute(0, 3, 1, 2), conv.weight.double(), conv.bias.double(), padding=3)
    z = z.permute(0, 2, 3, 1)
    z = F.gelu(z) if gelu else z
    return z if residual is None else residual.double() + z


@pytest.fixture(scope="module", params=list(SCENES))
def scene_refinement(request):
    """Both launches of a scene's refinement: (name, [(input, conv, gelu,
    residual, float64 output)])."""
    _card()
    conv1, conv2 = (c.cuda() for c in convs(c=128, seed=7))
    x = features((SCENES[request.param], 256, 256, 128), seed=8, device="cuda")
    with torch.no_grad():
        hidden = _f64(x, conv1, True, None)
        cases = [(x, conv1, True, None, hidden), (hidden.float(), conv2, False, x, None)]
        cases[1] = cases[1][:4] + (_f64(*cases[1][:4]),)
    return request.param, cases


@pytest.mark.cuda
def test_k9_is_within_twice_cudnn_float32_error_and_plain_tf32_is_not(scene_refinement):
    name, cases = scene_refinement
    for inp, conv, gelu, residual, want in cases:
        base = 0.0 if residual is None else residual.double()
        with torch.no_grad():
            k9, _ = conv7_kernel.launch(inp, conv.weight, conv.bias, residual, gelu)
            tf32, _ = conv7_kernel.launch(inp, conv.weight, conv.bias, residual, gelu, terms=1)
            cudnn = plain_f32(inp, conv, gelu, residual)
        torch.cuda.synchronize()
        e_k9, e_tf32, e_cudnn = (rel_rms(t, want, base) for t in (k9, tf32, cudnn))
        print(f"{name} {'conv1' if gelu else 'conv2'}: relative RMS error against float64: K9 {e_k9:.3g}, "
              f"TF32 {e_tf32:.3g}, cuDNN float32 {e_cudnn:.3g}")
        assert e_k9 <= 2 * e_cudnn
        assert e_tf32 > 2 * e_cudnn


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 16, 16, 128), (2, 13, 21, 32, 256), (1, 5, 40, 48, 128)])
def test_k9_matches_its_plain_twin(shape):
    """Ragged tiles, several chunks and output blocks, each epilogue."""
    _card()
    n, h, w, c_in, c_out = shape
    torch.manual_seed(9)
    conv = nn.Conv2d(c_in, c_out, 7, 1, 3).cuda()
    x = features((n, h, w, c_in), seed=10, device="cuda")
    residual = features((n, h, w, c_out), seed=11, device="cuda")
    for gelu, res in ((True, None), (False, residual), (False, None)):
        with torch.no_grad():
            out, pre = conv7_kernel.launch(x, conv.weight, conv.bias, res, gelu, pre=True)
            want = conv7_kernel.conv7_split_plain(x, conv.weight, conv.bias, res, gelu)
            want_pre = conv7_kernel.conv7_split_plain(x, conv.weight, conv.bias)
        base = 0.0 if res is None else res.double()
        assert rel_rms(out, want, base) < 1e-6
        assert rel_rms(pre, want_pre, 0.0) < 1e-6


@pytest.mark.cuda
def test_k9_sees_an_in_place_weight_update():
    _card()
    torch.manual_seed(15)
    conv = nn.Conv2d(16, 64, 7, 1, 3).cuda()
    x = features((1, 16, 8, 16), seed=16, device="cuda")
    with torch.no_grad():
        before, _ = conv7_kernel.launch(x, conv.weight, conv.bias)
        conv.weight.mul_(-0.5)
        after, _ = conv7_kernel.launch(x, conv.weight, conv.bias)
        want = conv7_kernel.conv7_split_plain(x, conv.weight, conv.bias)
    assert rel_rms(after, want, 0.0) < 1e-6
    assert rel_rms(before, want, 0.0) > 0.5


@pytest.mark.cuda
def test_refine_on_the_card_routes_and_differentiates():
    _card()
    conv1, conv2 = (c.cuda() for c in convs(c=128, seed=12))
    x = features((2, 24, 40, 128), seed=13, device="cuda")
    with torch.no_grad():
        out = conv7_kernel.refine(x, conv1, conv2)
        want = conv7_kernel.refine_plain(x, conv1, conv2)
    assert tracing.counter("conv7_launches") == 2
    assert rel_rms(out, want, x.double()) < 1e-5

    seq = nn.Sequential(conv1, nn.GELU(), conv2)
    xg = x.clone().requires_grad_()
    cot = features(x.shape, seed=14, device="cuda")
    got = torch.autograd.grad((conv7_kernel.refine(xg, conv1, conv2) * cot).sum(), (xg, *seq.parameters()))
    assert tracing.counter("conv7_launches") == 4
    want_out = xg + seq(xg.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    wants = torch.autograd.grad((want_out * cot).sum(), (xg, *seq.parameters()))
    for g, w in zip(got, wants):
        assert rel_rms(g, w, 0.0) < 1e-5

    b1, b2 = convs(c=128, seed=12, dtype=torch.bfloat16)
    with torch.no_grad():
        bf16 = conv7_kernel.refine(x, b1.cuda(), b2.cuda())
    assert tracing.counter("conv7_launches") == 4 and bf16.dtype == torch.float32
