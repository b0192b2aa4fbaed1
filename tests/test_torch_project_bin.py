"""The rasterizer's projection, binning and settings probe: which version a
call runs, and, on the card, the kernels (`csrc/project_bin.cu`) against
their plain versions on the same CUDA tensors.

On the CPU every stage runs its plain version, and the launch counters stay
at 0. The card tests (marked `cuda`) import nothing of the JAX package; run
them on the card with

    python -m pytest tests/test_torch_project_bin.py -m cuda --noconftest -p no:cacheprovider
"""

from pathlib import Path

import pytest
import torch

from pixelsplat_tpu_torch import kernel_build
from pixelsplat_tpu_torch.ops.rasterizer import adaptive, binning, project_bin_kernel
from pixelsplat_tpu_torch.ops.rasterizer.composite import composite_tiles
from pixelsplat_tpu_torch.ops.rasterizer.projection import (
    aos_planes,
    pack_gaussians_soa,
    project_gaussians,
    project_gaussians_soa_plain,
    rescaled,
    soa_planes,
)
from pixelsplat_tpu_torch.ops.rasterizer.render import RenderSettings, render
from pixelsplat_tpu_torch.utils import tracing

IMAGE = (32, 48)
COUNTERS = ("project_launches", "bin_launches", "occupancy_launches")


@pytest.fixture(autouse=True)
def one_thread_and_fresh_counters():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.reset()
    yield
    torch.set_num_threads(threads)
    tracing.reset()


def scene(seed=0, g=300, views=3, cov_scale=0.05, device="cpu"):
    """Random Gaussians in front of `views` cameras along x: (cameras
    (extrinsics, intrinsics, near, far), means, covariances, SH, opacities)."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.linspace(2.0, 8.0, g)[torch.randperm(g, generator=gen)]
    means = torch.stack([torch.rand(g, generator=gen) * 2 - 1, torch.rand(g, generator=gen) * 2 - 1, z], dim=-1)
    axes = torch.randn((g, 3, 3), generator=gen) * cov_scale
    covs = axes @ axes.transpose(1, 2) + 1e-4 * torch.eye(3)
    sh = torch.randn((g, 3, 4), generator=gen) * 0.3
    opac = torch.rand(g, generator=gen) * 0.7 + 0.2
    extr = torch.eye(4).repeat(views, 1, 1)
    extr[:, 0, 3] = torch.linspace(-0.3, 0.3, views)
    intr = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]).repeat(views, 1, 1)
    near, far = torch.full((views,), 1.5), torch.full((views,), 100.0)
    cams = tuple(t.to(device) for t in (extr, intr, near, far))
    return cams, means.to(device), covs.to(device), sh.to(device), opac.to(device)


def batched(*scene_tensors):
    """The scene's tensors repeated (as views) for each of the 3 cameras."""
    return [x[None].expand(3, *x.shape) for x in scene_tensors]


def plain_render(cams, means, covs, sh, opac, settings, scale_invariant=True):
    """`render`'s images of batched Gaussians (b, g, ...) composed from the
    plain versions by hand."""
    extr, intr, near, _ = cams
    images = []
    for v in range(extr.shape[0]):
        soa = pack_gaussians_soa(means[v], covs[v], opac[v], harmonics=sh[v])
        e, s = rescaled(extr[v], soa, near[v]) if scale_invariant else (extr[v], soa)
        projected = project_gaussians_soa_plain(e, intr[v], IMAGE, s)
        tiles = binning.bin_gaussians_plain(
            projected, IMAGE, settings.tile_size, settings.capacity, settings.span, settings.big_capacity,
            settings.chunk, settings.pair_budget, settings.force_wide_keys,
        )
        images.append(composite_tiles(projected, tiles, IMAGE, torch.zeros(3, device=means.device), settings.tile_size,
                                     settings.chunk))
    return torch.stack(images)


@pytest.mark.parametrize("scale_invariant", [True, False])
def test_render_on_the_cpu_runs_the_plain_code_and_launches_nothing(scale_invariant):
    cams, means, covs, sh, opac = scene(1)
    settings = RenderSettings(capacity=256, big_capacity=32, chunk=64)
    b = cams[0].shape[0]
    inputs = batched(means, covs, sh, opac)
    got = render(*cams, IMAGE, torch.zeros((b, 3)), *inputs, scale_invariant=scale_invariant, settings=settings)
    want = plain_render(cams, *inputs, settings, scale_invariant)
    assert torch.equal(got, want)
    assert all(tracing.counter(c) == 0 for c in COUNTERS)


def test_render_gradients_on_the_cpu_are_the_plain_codes():
    cams, means, covs, sh, opac = scene(2, g=200)
    settings = RenderSettings(capacity=256, big_capacity=32, chunk=64)
    b = cams[0].shape[0]
    grads = []
    for by_hand in (False, True):
        leaves = [x.clone().requires_grad_() for x in (means, covs, sh, opac)]
        if by_hand:
            image = plain_render(cams, *batched(*leaves), settings)
        else:
            image = render(*cams, IMAGE, torch.zeros((b, 3)), *batched(*leaves), settings=settings)
        (image * torch.linspace(0.5, 1.5, image.numel()).reshape(image.shape)).sum().backward()
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        assert torch.equal(got, want)
    assert all(tracing.counter(c) == 0 for c in COUNTERS)


@pytest.mark.parametrize("big_capacity", [64, 4])
def test_the_soa_probe_chooses_what_the_aos_probe_chooses(big_capacity):
    cams, means, covs, sh, opac = scene(3, g=400, cov_scale=0.3)
    extr, intr, near, _ = cams
    b, g = extr.shape[0], means.shape[0]
    settings = RenderSettings(capacity=4096, big_capacity=big_capacity, chunk=64)
    soa = pack_gaussians_soa(means, covs, opac, harmonics=sh)
    got = adaptive.probe(extr, intr, near, soa_planes(soa), IMAGE, settings)
    planes = aos_planes(means[None].expand(b, g, 3), covs[None].expand(b, g, 3, 3), opac[None].expand(b, g))
    want = adaptive.probe(extr, intr, near, planes, IMAGE, settings)
    assert got == want
    assert adaptive.choose_settings(got, settings, g, IMAGE) == adaptive.choose_settings(want, settings, g, IMAGE)
    assert all(tracing.counter(c) == 0 for c in COUNTERS)


def test_the_probe_counts_what_count_big_and_tile_occupancy_count():
    """The probe's plain path, from the ten planes, against the per-view
    projections and counts it replaced."""
    cams, means, covs, sh, opac = scene(4, g=400, cov_scale=0.3)
    extr, intr, near, _ = cams
    b, g = extr.shape[0], means.shape[0]
    planes = aos_planes(means[None].expand(b, g, 3), covs[None].expand(b, g, 3, 3), opac[None].expand(b, g))
    settings = RenderSettings(tile_size=16, span=2, big_capacity=8, chunk=64)
    max_count, budget, big_capacity = adaptive.probe(extr, intr, near, planes, IMAGE, settings)
    projected = []
    for v in range(b):
        scale = 1.0 / near[v]
        e = extr[v].clone()
        e[:3, 3] = e[:3, 3] * scale
        projected.append(project_gaussians(e, intr[v], IMAGE, means * scale, covs * scale**2, opac,
                                           colors_precomp=torch.zeros((g, 1))))
    n_big = max(int(binning.count_big(p, IMAGE, 16, 2)) for p in projected)
    assert n_big > 8  # the big list grows
    assert big_capacity == -(-n_big // 64) * 64
    stats = [binning.tile_occupancy(p, IMAGE, 16, 2, big_capacity, 64) for p in projected]
    assert max_count == max(int(m) for m, _ in stats)
    assert budget == max(int(x) for _, x in stats)


@pytest.mark.parametrize("case", ["default", "span3", "wide", "budget"])
def test_bin_shape_gives_the_sizes_of_the_plain_lists(case):
    cams, means, covs, sh, opac = scene(5)
    kw = {
        "default": dict(capacity=256, span=2, big_capacity=32, chunk=64),
        "span3": dict(capacity=4096, span=3, big_capacity=500, chunk=128),
        "wide": dict(capacity=256, span=2, big_capacity=32, chunk=64, force_wide_keys=True),
        "budget": dict(capacity=256, span=2, big_capacity=32, chunk=64, pair_budget=1000),
    }[case]
    projected = project_gaussians(cams[0][0], cams[1][0], IMAGE, means, covs, opac, harmonics=sh)
    tiles = binning.bin_gaussians(projected, IMAGE, tile_size=16, **kw)
    shape = binning.bin_shape(means.shape[0], IMAGE, 16, kw["capacity"], kw["span"], kw["big_capacity"], kw["chunk"],
                              kw.get("pair_budget"), kw.get("force_wide_keys", False))
    assert tiles.flat.numel() == shape.pair_budget and shape.pair_budget % kw["chunk"] == 0
    assert tiles.counts.numel() == shape.num_tiles == shape.tiles_x * shape.tiles_y == 6
    assert int(tiles.counts.max()) <= shape.capacity
    assert shape.big_capacity == min(kw["big_capacity"], means.shape[0])
    assert shape.wide_keys == (case == "wide")


def test_loading_a_rasterizer_library_builds_its_partner_beside_it(monkeypatch):
    """The first load of projection and binning, of K1 or of the encoder's
    K10 or K9 compiles all four at once, one nvcc each; other sources build
    alone."""
    built = []
    monkeypatch.setattr(kernel_build, "build_many", lambda names: built.append(tuple(names)))
    monkeypatch.setattr(kernel_build, "build", lambda name, csrc=None: (Path(f"lib{name}.so"), ""))
    monkeypatch.setattr(kernel_build.ctypes, "CDLL", str)
    monkeypatch.setattr(kernel_build, "_loaded", {})
    for name in ("project_bin", "composite_fwd", "conv7", "linear_split", "copy_rows", "project_bin"):
        assert kernel_build.load(name) == f"lib{name}.so"
    assert built == [("linear_split", "conv7", "composite_fwd", "project_bin")] * 4 + [("copy_rows",)]


def test_bin_shape_takes_wide_keys_only_where_the_tiles_leave_under_12_depth_bits():
    assert not binning.bin_shape(1, (8192, 8192), 16, 1, 2, 1, 128, None, False).wide_keys  # 2^18 tiles
    assert binning.bin_shape(1, (16384, 16384), 16, 1, 2, 1, 128, None, False).wide_keys  # 2^20 tiles


def test_the_kernel_wrappers_read_strides_of_views_and_refuse_other_shapes():
    means = torch.zeros((7, 3))
    covs = torch.zeros((7, 3, 3))
    device = torch.device("cpu")
    planes = aos_planes(means[None].expand(4, 7, 3), covs[None].expand(4, 7, 3, 3), torch.zeros(4, 7))
    assert project_bin_kernel._plane(planes[0], 7, 4, device, "x")[1:] == (3, 0)
    assert project_bin_kernel._plane(planes[4], 7, 4, device, "s01")[1:] == (9, 0)
    assert project_bin_kernel._plane(planes[4], 7, 4, device, "s01")[0] == covs.data_ptr() + 4
    assert project_bin_kernel._plane(torch.zeros((4, 7)), 7, 4, device, "o")[1:] == (1, 7)
    assert project_bin_kernel._plane(torch.zeros(7), 7, 4, device, "o")[1:] == (1, 0)
    with pytest.raises(ValueError):
        project_bin_kernel._plane(torch.zeros(8), 7, 4, device, "o")
    with pytest.raises(ValueError):
        project_bin_kernel._plane(torch.zeros(7, dtype=torch.float64), 7, 4, device, "o")
    with pytest.raises(ValueError):
        project_bin_kernel._cameras(torch.zeros((2, 4, 4)), torch.zeros((2, 3, 3)), None, 3, device)
    strided = torch.zeros((3, 2))[:, 0]
    assert project_bin_kernel._cameras(torch.zeros((3, 4, 4)), torch.zeros((3, 3, 3)), strided, 3, device)[2].is_contiguous()
    assert not project_bin_kernel.takes(torch.zeros(3), None)


# On the card.

MODELS = ["re10k", "re10k_3_view"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", params=MODELS)
def card_inputs(request):
    _card()
    from pixelsplat_tpu_torch.scripts import check_project_bin

    return check_project_bin.scene_inputs(request.param)


@pytest.mark.cuda
def test_pytorch_divides_by_a_scalar_as_the_kernels_assume():
    """The tile test's `opacity / MIN_ALPHA` on a CUDA tensor is a product
    with the reciprocal taken in double and rounded to float, which
    `csrc/project_bin.cu` repeats (`kInvMinAlpha`)."""
    _card()
    x = torch.rand(1 << 20, device="cuda") + 1.0 / 255.0
    assert torch.equal(x / (1.0 / 255.0), x * 255.0)


@pytest.mark.cuda
def test_projection_kernel_agrees_with_the_plain_projection(card_inputs):
    """Both round op by op, but the plain code inverts the camera with a
    matrix product and takes the field of view through `get_fov`'s ops, so
    the kernel's camera differs by ulps: every field within 1e-5 of its
    largest magnitude, and a Gaussian's `valid` or radius (a ceiling) may
    differ only where that moves it across an integer, 1e-4 of the scene's
    Gaussians at most."""
    from pixelsplat_tpu_torch.scripts import check_project_bin

    g = card_inputs["soa"].mean_x.numel()
    for v in range(card_inputs["cams"][0].shape[0]):
        diff = check_project_bin.compare_projection(*check_project_bin.projection_pair(card_inputs, v))
        print(card_inputs["model"], v, diff)
        assert diff["valid"] > g // 10
        assert all(diff[f] <= 1e-5 for f in ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "depth", "color"))
        assert diff["valid_differ"] + diff["radius_differ"] <= g * 1e-4


@pytest.mark.cuda
def test_binning_kernels_give_the_plain_lists_exactly(card_inputs):
    from pixelsplat_tpu_torch.scripts import check_project_bin

    overflowed = set()
    for name, projected, shape, kw in check_project_bin.binning_cases(card_inputs):
        tracing.reset()
        kernel = binning.bin_gaussians(projected, shape, **kw)
        assert tracing.counter("bin_launches") == 1, name
        plain = binning.bin_gaussians_plain(projected, shape, **kw)
        assert check_project_bin.lists_equal(kernel, plain), name
        assert int(plain.counts.sum()) > 0, name
        if int(plain.overflow) > 0:
            overflowed.add(name)
    assert "view 0 big overflow" in overflowed


@pytest.mark.cuda
def test_occupancy_kernel_counts_what_the_plain_code_counts(card_inputs):
    from pixelsplat_tpu_torch.scripts import check_project_bin

    for big_capacity, span in check_project_bin.OCCUPANCY_CASES:
        kernel, plain = check_project_bin.occupancy_pair(card_inputs, big_capacity, span)
        assert kernel == plain, (big_capacity, span)
    assert kernel[0] > big_capacity  # the last case grows the big list


@pytest.mark.cuda
def test_a_scene_launches_each_kernel_and_syncs_only_where_declared():
    """One evaluation scene: the probe projects its 3 views in one launch
    and counts them in one, each target view projects and bins once, and
    no sync that the debug mode sees is undeclared."""
    _card()
    from pixelsplat_tpu_torch.scripts.eval_scene import make_eval_scene

    scene = make_eval_scene("cuda", seed=1)
    scene.run(1)  # builds the kernels and warms every shape
    torch.cuda.synchronize()
    tracing.reset()
    tracing.enable(True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, color, overflow = scene.run(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        tracing.enable(False)
    torch.cuda.synchronize()
    got = tracing.read()
    print(tracing.table(got))
    assert int(overflow) == 0 and bool(torch.isfinite(color).all())
    counters = got["counters"]
    assert (counters["project_launches"], counters["bin_launches"], counters["occupancy_launches"]) == (4, 3, 1)
    assert not {"upload.inverse_se3", "upload.fov_vector"} & set(got["spans"])
    assert got["spans"]["settings.read"]["calls"] == 2


@pytest.mark.cuda
def test_renders_that_need_a_gradient_project_plainly_and_bin_with_the_kernels():
    _card()
    cams, means, covs, sh, opac = scene(6, g=3000, device="cuda")
    settings = RenderSettings(capacity=512, big_capacity=64, chunk=64)
    b = cams[0].shape[0]
    grads = []
    for by_hand in (False, True):
        tracing.reset()
        leaves = [x.clone().requires_grad_() for x in (means, covs, sh, opac)]
        if by_hand:
            image = plain_render(cams, *batched(*leaves), settings)
        else:
            image = render(*cams, IMAGE, torch.zeros((b, 3), device="cuda"), *batched(*leaves), settings=settings)
            assert (tracing.counter("project_launches"), tracing.counter("bin_launches")) == (0, b)
        image.sum().backward()
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        # K2 adds up each Gaussian's gradient over its pairs with atomics, in
        # an order that changes from run to run: equal to f32 rounding of the
        # largest gradient.
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    with torch.no_grad():
        e, soa = rescaled(cams[0][0], pack_gaussians_soa(means, covs, opac, harmonics=sh), cams[2][0])
        projected = project_gaussians_soa_plain(e, cams[1][0], IMAGE, soa)
        kw = dict(capacity=settings.capacity, span=settings.span, big_capacity=settings.big_capacity, chunk=64)
        assert all(torch.equal(a, b) for a, b in zip(binning.bin_gaussians(projected, IMAGE, **kw),
                                                     binning.bin_gaussians_plain(projected, IMAGE, **kw)))
