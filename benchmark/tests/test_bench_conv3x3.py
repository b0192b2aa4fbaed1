"""`conv3x3_roofline.eval`'s work count and kernel pattern: the reference
model's stride-1 3x3 convolutions' FLOPs a context pixel, and a symbol that
finds the split-precision 3x3 kernel and none of cuDNN's, K9's or K10's."""

from __future__ import annotations

import re
from types import SimpleNamespace

import pytest
import torch
from torch import nn

from benchmark import spec, work
from benchmark.profiling import Trace

read = spec.metric_reader("conv3x3_roofline.eval")
metric = read.__globals__

OTHERS = [
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize128x128x8_stage3_warpsize2x2x1_g1_ffma_"
    "aligna4_alignc4_execute_kernel__5x_cudnn",
    "void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, false, false, true>(int, int, int, float const*, "
    "int, float*, float const*, kernel_conv_params, unsigned long long, int, float, float, int, float const*, "
    "float const*, bool, int, int)",
    "void (anonymous namespace)::conv7_kernel<3>((anonymous namespace)::Args)",
    "void (anonymous namespace)::linear_split_kernel<128, 3>(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Args)",
]
K11 = [
    "void (anonymous namespace)::conv3x3_split_kernel<176>((anonymous namespace)::Args)",
    "void (anonymous namespace)::conv3x3_split_kernel<32>((anonymous namespace)::Args)",
]


def reference_convolutions(views: int = 2, size: int = 256) -> list[tuple]:
    """(module, c_out, stride, kernel, FLOP) of every convolution call the
    `mvsplat` reference model makes in one scene, hooked on meta tensors (its
    CNN runs view by view)."""
    config = spec.load_json(spec.HERE / "configs" / "mvsplat.json")
    config = {**config, "image_shape": [size, size],
              "encoder": {**config["encoder"], "num_context_views": views}}
    calls = []

    def hook(module, inputs, out):
        n, c, h, w = out.shape
        k = module.kernel_size
        calls.append((id(module), module.out_channels, module.stride, k,
                      2 * module.in_channels * k[0] * k[1] * c * n * h * w))

    with torch.device("meta"):
        model = spec.reference_module(config).Encoder(config["encoder"])
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.register_forward_hook(hook)
        ctx = {k: t.to("meta") for k, t in work._context(config, 1).items()}
        with torch.no_grad():
            model(ctx, 0, None, None)
    return calls


def test_flop_count_is_the_references_stride1_3x3_convolutions():
    calls = reference_convolutions()
    mine = [c for c in calls if c[3] == (3, 3) and c[2] == (1, 1) and c[1] >= 8]
    assert len({c[0] for c in mine}) == 87
    assert sum(c[4] for c in mine) == 227_379_511_296
    assert metric["FLOP_PER_PIXEL"] * 2 * 256 * 256 == sum(c[4] for c in mine)
    left = [c for c in calls if c not in mine]  # stride 2, the 7x7 stem, 1x1, the 64 -> 2 head: 7.3 GFLOP
    assert sum(c[4] for c in left) < 0.05 * sum(c[4] for c in mine)


def test_pattern_finds_k11_and_no_other_kernel():
    rx = re.compile(metric["PATTERN"])
    assert all(rx.search(name) for name in K11)
    assert not any(rx.search(name) for name in OTHERS)
    for other in ("conv7_kernel", "linear_split_kernel"):
        assert not any(re.search(other, name) for name in K11)


def test_share_over_the_traced_views():
    """Two traced scenes of two 256x256 views over K11's time in the trace;
    other kernels' time is not counted."""
    image = torch.zeros(1, 2, 3, 256, 256)
    units = [SimpleNamespace(batch={"context": {"image": image}})] * 3
    trace = Trace(device=[(K11[0], 0.0, 2000.0), (OTHERS[0], 2000.0, 9000.0), (K11[1], 9000.0, 10000.0)])
    run = SimpleNamespace(kind="eval", trace=trace, traced=[0, 2], outputs={"units": units})
    want = 100.0 * 1_734_768 * 4 * 256 * 256 / (495e12 / 3) / 3e-3
    assert read(run) == pytest.approx(want)


def test_reads_nothing_without_k11():
    image = torch.zeros(1, 2, 3, 256, 256)
    units = [SimpleNamespace(batch={"context": {"image": image}})]
    run = SimpleNamespace(kind="eval", trace=Trace(device=[(n, 0.0, 1000.0) for n in OTHERS]), traced=[0],
                          outputs={"units": units})
    assert read(run) is None
    run.trace = None
    assert read(run) is None
