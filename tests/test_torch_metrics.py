"""The port's image metrics against the JAX package's, and its Benchmarker,
on the CPU.

PSNR is held within 1e-5 dB and SSIM within 1e-6 of the JAX functions on
the same random (2, 3, 64, 64) images: both are float32 means over 12,288
values per image (SSIM of five separable Gaussian filters first), summed in
another order on each side, which moves the result by a few float32
roundings (~1e-7 of values near 1; PSNR's 10 log10 turns a relative error
e of the mean into 4.3 e dB).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.evaluation import metrics as jx_metrics
from pixelsplat_tpu.utils.benchmarker import Benchmarker as JxBenchmarker
from pixelsplat_tpu_torch.evaluation import metrics as pt_metrics
from pixelsplat_tpu_torch.utils.benchmarker import Benchmarker

PSNR_ATOL_DB = 1e-5
SSIM_ATOL = 1e-6


def image_pair(case: str, seed: int):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    if case == "random":
        hat = rng.uniform(0, 1, gt.shape).astype(np.float32)
    elif case == "noisy":  # a render close to the ground truth
        hat = (gt + rng.normal(0, 0.02, gt.shape)).astype(np.float32)
    elif case == "out_of_range":  # values beyond [0, 1] are clipped (PSNR) or kept (SSIM)
        hat = (gt + rng.normal(0, 0.3, gt.shape)).astype(np.float32)
    elif case == "smooth":  # low-frequency images: the windows' variances are small
        x = np.linspace(0, 1, 64, dtype=np.float32)
        phase = rng.uniform(0, 2 * np.pi)
        gt = np.broadcast_to(0.5 + 0.4 * np.sin(3 * x[None, :] + x[:, None] + phase), gt.shape).copy()
        hat = (gt + 0.05 * np.cos(5 * x)[None, None, None, :]).astype(np.float32)
    else:
        raise ValueError(case)
    return gt, hat


CASES = ["random", "noisy", "out_of_range"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_psnr_and_ssim_equal_jax(case, seed):
    gt, hat = image_pair(case, seed)
    psnr = pt_metrics.compute_psnr(torch.from_numpy(gt), torch.from_numpy(hat)).numpy()
    ssim = pt_metrics.compute_ssim(torch.from_numpy(gt), torch.from_numpy(hat)).numpy()
    want_psnr = np.asarray(jx_metrics.compute_psnr(jnp.asarray(gt), jnp.asarray(hat)))
    want_ssim = np.asarray(jx_metrics.compute_ssim(jnp.asarray(gt), jnp.asarray(hat)))
    assert psnr.shape == ssim.shape == (2,) and psnr.dtype == ssim.dtype == np.float32
    np.testing.assert_allclose(psnr, want_psnr, rtol=0, atol=PSNR_ATOL_DB)
    np.testing.assert_allclose(ssim, want_ssim, rtol=0, atol=SSIM_ATOL)


def test_smooth_images_within_float32_of_the_float64_value():
    """On smooth images the windows' variances (E[x^2] - E[x]^2) are small
    differences of numbers near 0.25-0.8, so float32 keeps fewer digits of
    them: each side lies ~4e-6 from the float64 SSIM (measured 3.9e-6 for
    the port, 2.1e-6 for JAX) and they differ by 6e-6. Both are held to 1e-5
    of the float64 value; PSNR to 1e-5 dB of JAX as above."""
    for seed in (0, 1):
        gt, hat = image_pair("smooth", seed)
        exact = pt_metrics.compute_ssim(torch.from_numpy(gt).double(), torch.from_numpy(hat).double()).numpy()
        ssim = pt_metrics.compute_ssim(torch.from_numpy(gt), torch.from_numpy(hat)).numpy()
        want_ssim = np.asarray(jx_metrics.compute_ssim(jnp.asarray(gt), jnp.asarray(hat)))
        np.testing.assert_allclose(ssim, exact, rtol=0, atol=1e-5)
        np.testing.assert_allclose(want_ssim, exact, rtol=0, atol=1e-5)
        psnr = pt_metrics.compute_psnr(torch.from_numpy(gt), torch.from_numpy(hat)).numpy()
        want_psnr = np.asarray(jx_metrics.compute_psnr(jnp.asarray(gt), jnp.asarray(hat)))
        np.testing.assert_allclose(psnr, want_psnr, rtol=0, atol=PSNR_ATOL_DB)


def test_identical_images():
    gt, _ = image_pair("random", 2)
    x = torch.from_numpy(gt)
    psnr = pt_metrics.compute_psnr(x, x.clone())
    want_psnr = np.asarray(jx_metrics.compute_psnr(jnp.asarray(gt), jnp.asarray(gt)))
    assert torch.isinf(psnr).all() and np.isinf(want_psnr).all() and (psnr > 0).all()
    ssim = pt_metrics.compute_ssim(x, x.clone()).numpy()
    want_ssim = np.asarray(jx_metrics.compute_ssim(jnp.asarray(gt), jnp.asarray(gt)))
    np.testing.assert_allclose(ssim, want_ssim, rtol=0, atol=SSIM_ATOL)
    np.testing.assert_allclose(ssim, 1.0, rtol=0, atol=SSIM_ATOL)


def test_gaussian_window_equals_jax():
    np.testing.assert_array_equal(pt_metrics._gaussian_kernel(1.5, 3.5), jx_metrics._gaussian_kernel(1.5, 3.5))
    assert pt_metrics._gaussian_kernel(1.5, 3.5).shape == (11,)  # skimage's win_size=11


def test_ssim_filter_leaves_tf32_setting_as_it_was():
    """The filter turns cuDNN's TF32 off around its convolutions and puts
    every cuDNN flag back."""
    cudnn = torch.backends.cudnn
    before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32)
    x = torch.rand((1, 3, 32, 32), generator=torch.Generator().manual_seed(0))
    pt_metrics.compute_ssim(x, x.flip(-1))
    assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32) == before


def test_benchmarker_on_the_cpu(tmp_path):
    bench = Benchmarker("cpu")
    with bench.time("encoder"):
        pass
    with bench.time("decoder", num_calls=3):
        bench.sync()
    with bench.time("encoder"):
        pass
    assert len(bench.execution_times["encoder"]) == 2
    assert len(bench.execution_times["decoder"]) == 3
    assert len(set(bench.execution_times["decoder"])) == 1  # one block split evenly
    summary = bench.summarize()
    assert set(summary) == {"encoder", "decoder"}
    assert summary["decoder"] == pytest.approx(bench.execution_times["decoder"][0])

    bench.dump(tmp_path / "a" / "benchmark.json")
    assert json.loads((tmp_path / "a" / "benchmark.json").read_text()) == dict(bench.execution_times)
    bench.dump_memory(tmp_path / "a" / "peak_memory.json")
    assert json.loads((tmp_path / "a" / "peak_memory.json").read_text()) == {}
    bench.clear_history()
    assert bench.summarize() == {}


def test_benchmarker_device_clock(monkeypatch):
    """`time_device` takes the host clock off the card; on a card it records
    CUDA events and reads them, after one sync, only when the times are
    read (the events are faked here: no card)."""
    bench = Benchmarker("cpu")
    with bench.time_device("forward"):
        pass
    assert len(bench.execution_times["forward"]) == 1

    class Event:
        clock_ms = 0.0

        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self):
            Event.clock_ms += 2.5
            self.at = Event.clock_ms

        def elapsed_time(self, end):
            return end.at - self.at

    synced = []
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    bench = Benchmarker("cuda:0")
    for _ in range(2):
        with bench.time_device("backward"):
            pass
    assert bench.execution_times == {} and synced == []  # no sync while timing
    assert bench.summarize() == {"backward": pytest.approx(2.5e-3)}
    assert len(synced) == 1 and bench.execution_times["backward"] == pytest.approx([2.5e-3, 2.5e-3])


def test_benchmarker_files_have_the_jax_layout(tmp_path):
    """The same calls give the same JSON keys and entry counts as the JAX
    Benchmarker (the times themselves differ)."""
    files = {}
    for name, bench in (("jax", JxBenchmarker()), ("port", Benchmarker())):
        for tag, calls in (("encoder", 1), ("decoder", 3), ("encoder", 1)):
            with bench.time(tag, num_calls=calls):
                pass
        bench.dump(tmp_path / name / "benchmark.json")
        files[name] = json.loads((tmp_path / name / "benchmark.json").read_text())
    assert {k: len(v) for k, v in files["port"].items()} == {k: len(v) for k, v in files["jax"].items()}


def test_benchmarker_memory_stats_on_a_cuda_device(monkeypatch):
    """On the card the dump holds torch.cuda.memory_stats as ints plus the
    two keys the paper's benchmark table reads (the stats are faked here:
    no card)."""
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: {"allocated_bytes.all.peak": 7.0})
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: 7)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 5)
    stats = Benchmarker("cuda:0").memory_stats()
    assert stats == {"allocated_bytes.all.peak": 7, "peak_bytes_in_use": 7, "bytes_in_use": 5}
    assert all(type(v) is int for v in stats.values())
