"""The DINO ViT's linear layers (`ops/linear_kernel.py`, K10 in
`csrc/linear_split.cu`): the split-precision twin, which version a call
runs, the block width, the gradient, and on the card the kernel against a
float64 product.

The JAX package's parity tests that cover the ViT are
`test_torch_encoder.py` and `test_torch_re10k.py`, on the CPU, where its
layers take the same plain float32 route as before K10. The card tests
(marked `cuda`) import nothing of the JAX package; run them on the card with

    python -m pytest tests/test_torch_linear_split.py -m cuda --noconftest -p no:cacheprovider
"""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from pixelsplat_tpu_torch.model import precision
from pixelsplat_tpu_torch.model.encoder.backbone import dino
from pixelsplat_tpu_torch.ops import linear_kernel
from pixelsplat_tpu_torch.utils import tracing

# Relative RMS error against float64 at the ViT's widths, over the RMS of
# the product's own term: on the CPU the split twin and float32's own product
# both read 3.5e-7-4.0e-7 (mostly the output's rounding to float32), plain
# TF32 4.8e-4-5.5e-4.
TWIN_RTOL = 1e-6

# (K, N, epilogue) of a ViT-B block's four layers.
LAYERS = {"qkv": (768, 2304, "bias"), "proj": (768, 768, "residual"), "fc1": (768, 3072, "gelu"),
          "fc2": (3072, 768, "residual")}


@pytest.fixture(autouse=True)
def one_thread_and_fresh_counters():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.reset()
    yield
    torch.set_num_threads(threads)
    tracing.reset()


def tensor(shape, seed, device="cpu"):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device)


def layer_inputs(name, m, seed=0, device="cpu"):
    """x (m, K), the weight, the bias and the residual (or None) of layer
    `name`, at `nn.Linear`'s scale, and whether it takes the GELU."""
    k, n, epi = LAYERS[name]
    torch.manual_seed(seed)
    module = torch.nn.Linear(k, n)
    x = tensor((m, k), seed + 1, device)
    residual = tensor((m, n), seed + 2, device) if epi == "residual" else None
    return x, module.weight.detach().to(device), module.bias.detach().to(device), residual, epi == "gelu"


def f64(x, w, b, residual, gelu):
    z = F.linear(x.double(), w.double(), b.double())
    z = F.gelu(z) if gelu else z
    return z if residual is None else residual.double() + z


def rel_rms(got, want, base):
    """RMS of got - want over the RMS of the product's term want - base."""
    return float((got.double() - want.double()).pow(2).mean().sqrt() / (want.double() - base).pow(2).mean().sqrt())


@pytest.mark.parametrize("name", list(LAYERS))
def test_split_twin_holds_float64_and_plain_tf32_does_not(name):
    """At the ViT's widths, fc2's K = 3072 included; 40 rows stand for the
    tokens, whose count does not change an entry's error."""
    x, w, b, residual, gelu = layer_inputs(name, 40)
    with torch.no_grad():
        want = f64(x, w, b, residual, gelu)
        base = 0.0 if residual is None else residual.double()
        split = linear_kernel.linear_split_plain(x, w, b, residual, gelu)
        tf32 = linear_kernel.linear_split_plain(x, w, b, residual, gelu, terms=1)
        plain = F.linear(x, w, b)
        plain = F.gelu(plain) if gelu else plain
        plain = plain if residual is None else residual + plain
    assert rel_rms(split, want, base) <= TWIN_RTOL
    assert rel_rms(plain, want, base) <= TWIN_RTOL
    assert rel_rms(tf32, want, base) > 100 * TWIN_RTOL


def test_weight_split_parts():
    w = tensor((4096,), 3) * 1e3
    hi, lo = linear_kernel.weight_split(w)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())  # 10 mantissa bits
    # hi is w with its low 13 bits dropped, as the tensor cores read it; lo
    # holds the rest to 2^-11 of itself.
    assert torch.equal(hi.view(torch.int32), w.view(torch.int32) & -0x2000)
    assert bool((hi.abs() <= w.abs()).all()) and bool(((w - hi).abs() <= w.abs() * 2.0**-10).all())
    assert bool(((w - hi - lo).abs() <= (w - hi).abs() * 2.0**-11).all())


def block(dim=64, heads=4, dtype=None, seed=0):
    torch.manual_seed(seed)
    return dino.ViTBlock(dim, heads, dtype=dtype)


def block_by_hand(blk, x):
    """The block as it was written before K10: the modules and the adds."""
    a = blk.attn
    n, t, dim = x.shape
    h = blk.norm1(x)
    qkv = a.qkv(h).reshape(n, t, 3, a.heads, dim // a.heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    attn = torch.softmax(q / (dim // a.heads) ** 0.5 @ k.transpose(-1, -2), dim=-1)
    x = x + a.proj((attn @ v).transpose(1, 2).reshape(n, t, dim))
    return x + blk.mlp.fc2(F.gelu(blk.mlp.fc1(blk.norm2(x))))


def test_cpu_block_takes_the_plain_route_bit_for_bit():
    blk = block()
    x = tensor((2, 17, 64), 3)
    with torch.no_grad():
        got = blk(x)
        want = block_by_hand(blk, x)
    assert torch.equal(got, want)
    assert not linear_kernel.takes(x, blk.attn.qkv)
    assert tracing.counter("linear_split_launches") == 0


@pytest.mark.parametrize("epilogue", ["none", "gelu", "residual"])
def test_cpu_linear_is_the_module_bit_for_bit(epilogue):
    torch.manual_seed(4)
    module = precision.Linear(32, 64)
    x = tensor((3, 5, 32), 5)
    residual = tensor((3, 5, 64), 6) if epilogue == "residual" else None
    with torch.no_grad():
        got = linear_kernel.linear(module, x, residual, gelu=epilogue == "gelu")
        want = module(x)
        want = F.gelu(want) if epilogue == "gelu" else want
        want = want if residual is None else residual + want
    assert torch.equal(got, want)


def test_bf16_policy_keeps_precision_linear():
    blk = block(dtype=torch.bfloat16)
    seen = []
    for module in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
        module.register_forward_hook(lambda _m, _i, out: seen.append(out.dtype))
    x = tensor((1, 9, 64), 7)
    with torch.no_grad():
        out = blk(x)
    assert seen == [torch.bfloat16] * 4
    assert out.dtype == torch.float32  # the residual stream stays f32, as before
    assert tracing.counter("linear_split_launches") == 0
    assert not linear_kernel.takes(x.cuda() if torch.cuda.is_available() else x, blk.attn.qkv)


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_autograd_function_matches_the_plain_module(epilogue):
    torch.manual_seed(8)
    module = torch.nn.Linear(32, 64)
    x = tensor((2, 7, 32), 9).requires_grad_()
    residual = tensor((2, 7, 64), 10).requires_grad_() if epilogue == "residual" else None
    gelu = epilogue == "gelu"
    cot = tensor((2, 7, 64), 11)
    leaves = (x, module.weight, module.bias) + ((residual,) if residual is not None else ())

    out = linear_kernel.LinearSplit.apply(x, module.weight, module.bias, residual, gelu)
    got = torch.autograd.grad((out * cot).sum(), leaves)
    want_out = linear_kernel.linear_plain(module, x, residual, gelu)
    want = torch.autograd.grad((want_out * cot).sum(), leaves)
    assert torch.allclose(out, want_out, rtol=1e-5, atol=1e-6)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_rms(g, w, 0.0) < 1e-5


@pytest.mark.parametrize(
    "case, match",
    [("cpu", "CUDA tensors"), ("k", "K a multiple of 32"), ("n", "N of 64"), ("bias", r"\(N,\) bias"),
     ("residual", "residual must be"), ("dtype", "must be float32")],
)
def test_launch_refuses_what_the_kernel_does_not_take(case, match):
    """Each check before the device's, so CPU tensors show them all."""
    k, n = 64, 128
    x, w, b, residual = torch.zeros(4, k), torch.zeros(n, k), torch.zeros(n), None
    if case == "k":
        x, w = torch.zeros(4, 48), torch.zeros(n, 48)
    elif case == "n":
        w, b = torch.zeros(96, k), torch.zeros(96)
    elif case == "bias":
        b = None
    elif case == "residual":
        residual = torch.zeros(4, n + 64)
    elif case == "dtype":
        x = x.to(torch.float16)
    with pytest.raises(ValueError, match=match):
        linear_kernel.launch(x, w, b, residual)
    assert tracing.counter("linear_split_launches") == 0


@pytest.mark.parametrize(
    "k, n, want",
    [(768, 2304, True), (3072, 768, True), (576, 1024, True), (1024, 768, True), (1024, 4096, True),
     (48, 128, False), (64, 96, False), (64, 32, False)],
)
def test_takes_checks_the_kernels_shape_rule(k, n, want):
    """A CUDA float32 input under the float32 policy takes K10 only where
    K10 computes the layer's shape (K a multiple of 32, N of 64); another
    layer takes the plain route instead of raising in `launch`. The input
    is a stand-in that names a CUDA device, which a machine without a card
    cannot allocate on."""
    x = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32)
    assert linear_kernel.takes(x, precision.Linear(k, n)) is want
    assert not linear_kernel.takes(x, precision.Linear(k, n, compute_dtype=torch.bfloat16))


@pytest.mark.parametrize("k, n, policy, counted", [(48, 128, None, 1), (64, 96, None, 1), (48, 128, "bf16", 0)])
def test_a_float32_layer_off_the_rule_is_counted_on_its_plain_route(monkeypatch, k, n, policy, counted):
    """A float32 layer on the card at a shape K10 does not take runs plain
    and counts `linear_plain_on_card`; under the bf16 policy the plain route
    is the chosen one and counts nothing. The input is a stand-in that names
    a CUDA device, and the plain route a stand-in too."""
    monkeypatch.setattr(linear_kernel, "linear_plain", lambda *args: "plain")
    x = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32)
    module = precision.Linear(k, n, compute_dtype=torch.bfloat16 if policy else None)
    assert linear_kernel.linear(module, x) == "plain"
    assert tracing.counter("linear_plain_on_card") == counted
    assert tracing.counter("linear_split_launches") == 0


@pytest.mark.parametrize(
    "m, n, sms, want",
    [
        (2050, 768, 132, 128),  # 102 blocks at 128 fill one round; 204 at 64 take two
        (3075, 768, 132, 64),  # 150 blocks at 128 take two rounds; 300 at 64 three narrow ones
        (2050, 2304, 132, 128),  # 3 rounds at 128 against 5 narrow ones
        (2050, 3072, 132, 128),
        (3075, 3072, 132, 128),
        (2050, 64 * 3, 132, 64),  # only 64 divides n
        (128, 1024, 8, 128),  # 8 blocks at 128, one round
    ],
)
def test_tile_n_takes_the_width_whose_rounds_finish_first(m, n, sms, want):
    assert linear_kernel.tile_n(m, n, sms) == want


def test_tile_n_refuses_a_width_no_block_divides():
    with pytest.raises(ValueError):
        linear_kernel.tile_n(2050, 96, 132)


def test_vit_calls_the_kernel_route_for_each_layer(monkeypatch):
    blk = block()
    calls = []
    original = linear_kernel.linear

    def spy(module, x, residual=None, gelu=False):
        calls.append((module, residual is not None, gelu))
        return original(module, x, residual, gelu)

    monkeypatch.setattr(linear_kernel, "linear", spy)
    with torch.no_grad():
        blk(tensor((1, 5, 64), 12))
    a, m = blk.attn, blk.mlp
    assert calls == [(a.qkv, False, False), (a.proj, True, False), (m.fc1, False, True), (m.fc2, True, False)]


# On the card.

SCENES = {"re10k": 2, "re10k_3_view": 3}  # context views of 1025 tokens each


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("name", list(LAYERS))
def test_k10_is_within_twice_cublas_float32_error_and_plain_tf32_is_not(name, scene):
    _card()
    x, w, b, residual, gelu = layer_inputs(name, SCENES[scene] * 1025, seed=13, device="cuda")
    with torch.no_grad():
        want = f64(x, w, b, residual, gelu)
        base = 0.0 if residual is None else residual.double()
        k10 = linear_kernel.launch(x, w, b, residual, gelu)[0]
        tf32 = linear_kernel.launch(x, w, b, residual, gelu, terms=1)[0]
        lib = F.linear(x, w, b)
        lib = F.gelu(lib) if gelu else lib
        lib = lib if residual is None else residual + lib
    torch.cuda.synchronize()
    e_k10, e_tf32, e_lib = (rel_rms(t, want, base) for t in (k10, tf32, lib))
    print(f"{scene} {name}: relative RMS error against float64: K10 {e_k10:.3g}, TF32 {e_tf32:.3g}, "
          f"cuBLAS float32 {e_lib:.3g}")
    assert e_k10 <= 2 * e_lib
    assert e_tf32 > 2 * e_lib


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m, k, n",
    [(2, 32, 64), (130, 96, 192), (257, 3072, 128), (1000, 768, 2304), (2048, 576, 1024), (2048, 1024, 768),
     (2048, 1024, 3072), (2048, 1024, 1024), (2048, 1024, 4096), (2048, 4096, 1024)],
)
@pytest.mark.parametrize("width", linear_kernel.WIDTHS)
def test_k10_matches_its_plain_twin(m, k, n, width):
    """Ragged rows, an odd number of stages, both widths, each epilogue,
    the pre-activation and leading dimensions; the twin's parts summed in
    float64, since at GS-LRM's K 4096 float32's own rounding of the twin's
    products alone differs from K10 by 1.2e-6."""
    _card()
    if n % width:
        pytest.skip(f"n {n} is not a multiple of {width}")
    torch.manual_seed(14)
    module = torch.nn.Linear(k, n).cuda()
    x = tensor((1, m, k), 15, "cuda")
    residual = tensor((1, m, n), 16, "cuda")
    for gelu, res in ((True, None), (False, residual), (False, None)):
        with torch.no_grad():
            out, pre = linear_kernel.launch(x, module.weight, module.bias, res, gelu, pre=True, block_n=width)
            want = linear_kernel.linear_split_plain(x, module.weight, module.bias, res, gelu, dtype=torch.float64)
            want_pre = linear_kernel.linear_split_plain(x, module.weight, module.bias, dtype=torch.float64)
        base = 0.0 if res is None else res.double()
        assert out.shape == (1, m, n)
        assert rel_rms(out, want, base) < 1e-6
        assert rel_rms(pre, want_pre, 0.0) < 1e-6


@pytest.mark.cuda
def test_k10_sees_an_in_place_weight_update():
    _card()
    torch.manual_seed(17)
    module = torch.nn.Linear(64, 128).cuda()
    x = tensor((300, 64), 18, "cuda")
    with torch.no_grad():
        before = linear_kernel.launch(x, module.weight, module.bias)[0]
        module.weight.mul_(-0.5)
        after = linear_kernel.launch(x, module.weight, module.bias)[0]
        want = linear_kernel.linear_split_plain(x, module.weight, module.bias)
    assert rel_rms(after, want, 0.0) < 1e-6
    assert rel_rms(before, want, 0.0) > 0.5


@pytest.mark.cuda
def test_vit_block_on_the_card_routes_and_differentiates():
    _card()
    blk = block(dim=128, heads=4, seed=19).cuda()
    x = tensor((2, 129, 128), 20, "cuda")
    with torch.no_grad():
        out = blk(x)
        want = block_by_hand(blk, x)
    assert tracing.counter("linear_split_launches") == 4
    assert rel_rms(out, want, x.double()) < 1e-5

    xg = x.clone().requires_grad_()
    cot = tensor(x.shape, 21, "cuda")
    params = list(blk.parameters())
    got = torch.autograd.grad((blk(xg) * cot).sum(), (xg, *params))
    assert tracing.counter("linear_split_launches") == 8
    wants = torch.autograd.grad((block_by_hand(blk, xg) * cot).sum(), (xg, *params))
    for g, w in zip(got, wants):
        assert rel_rms(g, w, 0.0) < 1e-5

    bf16 = block(dim=128, heads=4, dtype=torch.bfloat16, seed=19).cuda()
    with torch.no_grad():
        assert bf16(x).dtype == torch.float32
    assert tracing.counter("linear_split_launches") == 8
