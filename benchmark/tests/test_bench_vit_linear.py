"""`vit_linear_roofline.eval`'s work count and kernel pattern: the ViT's
linear layers' FLOPs a token, the tokens of a view, and a symbol that finds
the split-precision linear kernel and none of cuBLAS's."""

from __future__ import annotations

import re
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import spec
from benchmark.profiling import Trace
from benchmark.reference.encoder import ViTBlock

read = spec.metric_reader("vit_linear_roofline.eval")
metric = read.__globals__

CUBLAS = [
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)",
    "void gemvx::kernel<int, int, float, float, float, float, false, true, true, false, 7, false, cublasGemvParamsEx<int, "
    "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float const>, "
    "cublasGemvTensorStridedBatched<float>, float> >(cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, "
    "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, float>)",
    "void (anonymous namespace)::conv7_kernel<3>((anonymous namespace)::Args)",
]
K10 = [
    "void (anonymous namespace)::linear_split_kernel<128, 3>(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Args)",
    "void (anonymous namespace)::linear_split_kernel<64, 3>(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Args)",
]


def test_flop_count_is_the_vit_blocks_linear_layers():
    assert metric["FLOP_PER_TOKEN"] == 2 * 768 * 9216 * 12
    n, d = 1025, 768
    with torch.device("meta"):
        block = ViTBlock(d, 12)
        x = torch.empty(1, n, d)
        with FlopCounterMode(display=False) as counter:
            block(x)
    linear = counter.get_total_flops() - 4 * n * n * d  # less the attention's two products
    assert metric["FLOP_PER_TOKEN"] == 12 * linear // n


@pytest.mark.parametrize("h, w, want", [(256, 256, 1025), (64, 128, 129)])
def test_tokens_of_a_view_are_its_patches_and_cls(h, w, want):
    assert metric["tokens"](h, w) == want


def test_pattern_finds_k10_and_no_library_kernel():
    rx = re.compile(metric["PATTERN"])
    assert all(rx.search(name) for name in K10)
    assert not any(rx.search(name) for name in CUBLAS)


def test_share_over_the_traced_views():
    """Two traced scenes of two 256x256 views: 4100 tokens over K10's time
    in the trace; other kernels' time is not counted."""
    image = torch.zeros(1, 2, 3, 256, 256)
    units = [SimpleNamespace(batch={"context": {"image": image}})] * 3
    trace = Trace(device=[(K10[0], 0.0, 2000.0), (CUBLAS[0], 2000.0, 9000.0), (K10[1], 9000.0, 10000.0)])
    run = SimpleNamespace(kind="eval", trace=trace, traced=[0, 2], outputs={"units": units})
    want = 100.0 * metric["FLOP_PER_TOKEN"] * 4100 / (495e12 / 3) / 3e-3
    assert read(run) == pytest.approx(want)
    run.trace = Trace(device=[(CUBLAS[0], 0.0, 1000.0)])
    assert read(run) is None
