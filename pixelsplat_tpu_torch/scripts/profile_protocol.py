"""The evaluation protocol scene by scene, over many scenes, on the GPU.

    python -m pixelsplat_tpu_torch.scripts.profile_protocol [--copies 64] [--chunks 16] [--out FILE]

The repo's fixture (`tests/fixtures/re10k`) holds two RE10K scenes. This
script writes `--copies` copies of each (the same JPEG frames, cameras and
evaluation-index entry under new keys) into `--chunks` chunk files with an
evaluation index, and a checkpoint of `re10k` with seeded random weights
(`write_checkpoint.py`, in a child process, so that this process first
touches the card inside `main`). It then runs
`pixelsplat_tpu_torch.main.main` on that scene set twice in this process,
as the CLI runs it (`+experiment=re10k mode=test`, the configured data
workers): the first run carries the process's start-up, the second shows
what a run adds in a process that is already warm.

Per scene it reads the Benchmarker's encoder and decoder times from the
run's `benchmark.json` and times the wait for the scene's batch around the
test loader's `next`. The rest of the scene's loop, what remains of the
time between two batches, it splits into the copy of the batch to the
device, PSNR + SSIM (each timed where the trainer calls it, ending in a
device sync), the PNG writes and the remainder (the images' copy to the
host, directories). It also times nvcc where the run builds a kernel, and
the data path alone with no workers, per scene. It prints the first scene
apart from the median, 10th and 90th percentiles over the
other scenes, beside the card's name and power limit, and writes every
per-scene number to `--out`. It fails unless every run scored every scene,
dropped no (Gaussian, tile) pair and launched the compositing kernel once
per target view.
"""

from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from contextlib import ExitStack, contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Iterator, Optional, Sequence, Union  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from .. import kernel_build  # noqa: E402
from .. import main as cli  # noqa: E402
from ..config import load_config  # noqa: E402
from ..dataset.data_module import DataModule  # noqa: E402
from ..training import trainer as trainer_module  # noqa: E402
from ..training.trainer import RESULTS_NAME  # noqa: E402
from ..utils import tracing  # noqa: E402
from .eval_scene import card_line  # noqa: E402

IMPORTS_S = time.perf_counter() - PROCESS_T0
FIXTURE = Path(__file__).resolve().parents[2] / "tests" / "fixtures"


def write_scene_set(out: Path, copies: int, chunks: int, stage: str = "test") -> tuple[Path, Path]:
    """`copies` copies of each fixture scene, spread in order over `chunks`
    chunk files under `out/<stage>/`, and their evaluation index; returns
    the dataset root and the index's path."""
    scenes = torch.load(FIXTURE / "re10k" / "test" / "000000.torch", map_location="cpu", weights_only=False)
    fixture_index = json.loads((FIXTURE / "evaluation_index_fixture.json").read_text())
    examples = [dict(scene, key=f"{scene['key']}_{c:04d}") for c in range(copies) for scene in scenes]
    directory = out / stage
    directory.mkdir(parents=True, exist_ok=True)
    chunk_of = {}
    for i, part in enumerate(np.array_split(np.arange(len(examples)), chunks)):
        name = f"{i:06d}.torch"
        torch.save([examples[j] for j in part], directory / name)
        chunk_of.update({examples[j]["key"]: name for j in part})
    (directory / "index.json").write_text(json.dumps(chunk_of))
    index = {e["key"]: fixture_index[e["key"].rsplit("_", 1)[0]] for e in examples}
    index_path = out / "evaluation_index.json"
    index_path.write_text(json.dumps(index))
    return out, index_path


class TimedLoader:
    """The test loader, with the seconds of each `next` and the clock at
    each batch's arrival."""

    def __init__(self, loader, record: dict):
        self.loader, self.record = loader, record

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                self.record["end"] = t0
                return
            t1 = time.perf_counter()
            self.record["wait"].append(t1 - t0)
            self.record["arrival"].append(t1)
            yield batch


@contextmanager
def timed(owner, name: str, calls: list, sync: bool = False) -> Iterator[None]:
    """Record (start, seconds) of every call of `owner.name` in `calls`,
    with a device sync before the clock stops where `sync` is set."""
    original = getattr(owner, name)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        if sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        calls.append((t0, time.perf_counter() - t0))
        return out

    setattr(owner, name, wrapped)
    try:
        yield
    finally:
        setattr(owner, name, original)


def per_scene(calls: list, arrival: np.ndarray) -> np.ndarray:
    """Milliseconds of `calls` summed per scene, by the batch they follow."""
    out = np.zeros(len(arrival))
    for t0, seconds in calls:
        out[max(int(np.searchsorted(arrival, t0, side="right")) - 1, 0)] += seconds * 1e3
    return out


def run_protocol(argv: list[str], device: Union[str, torch.device]) -> dict:
    """`main.main(argv)` with the test loader and the steps of each scene's
    loop timed; the per-scene numbers."""
    record = {"wait": [], "arrival": [], "end": None}
    calls = {k: [] for k in ("copy", "psnr", "ssim", "png", "nvcc")}
    tracing.reset()
    t0 = time.perf_counter()
    with ExitStack() as stack:
        stack.enter_context(timed(trainer_module, "batch_to", calls["copy"], sync=True))
        stack.enter_context(timed(trainer_module, "compute_psnr", calls["psnr"], sync=True))
        stack.enter_context(timed(trainer_module, "compute_ssim", calls["ssim"], sync=True))
        stack.enter_context(timed(Image.Image, "save", calls["png"]))
        stack.enter_context(timed(kernel_build, "build", calls["nvcc"]))
        test_dataloader = DataModule.test_dataloader
        DataModule.test_dataloader = lambda self: TimedLoader(test_dataloader(self), record)
        stack.callback(setattr, DataModule, "test_dataloader", test_dataloader)
        summary = cli.main(argv, device=device)
    wall = time.perf_counter() - t0
    launches = tracing.counter("k1_launches")

    cfg = load_config(argv)
    results = Path(cfg.test.output_path) / RESULTS_NAME
    bench = json.loads((results / "benchmark.json").read_text())
    memory = json.loads((results / "peak_memory.json").read_text())
    n = summary["num_scenes"]
    views = len(bench["decoder"]) // max(n, 1)
    arrival = np.asarray(record["arrival"])
    encoder = np.asarray(bench["encoder"]) * 1e3
    decoder_per_view = np.asarray(bench["decoder"]).reshape(n, views)[:, 0] * 1e3
    # A scene's loop runs from its batch's arrival to the request for the next.
    loop = (np.append(arrival[1:], record["end"]) - arrival) * 1e3
    parts = {k: per_scene(calls[k], arrival) for k in ("copy", "psnr", "ssim", "png")}
    rest = loop - encoder - views * decoder_per_view
    return dict(
        summary=summary, wall_s=wall, launches=launches, views_per_scene=views,
        pngs=len(list(results.rglob("*.png"))), peak_bytes=memory.get("peak_bytes_in_use"),
        to_first_batch_s=record["arrival"][0] - t0, after_last_scene_s=t0 + wall - record["end"],
        nvcc_s=sum(seconds for _, seconds in calls["nvcc"]),
        encoder_ms=encoder.tolist(), decoder_ms_per_view=decoder_per_view.tolist(),
        data_wait_ms=(np.asarray(record["wait"]) * 1e3).tolist(),
        copy_ms=parts["copy"].tolist(), metrics_ms=(parts["psnr"] + parts["ssim"]).tolist(),
        png_ms=parts["png"].tolist(), other_ms=(rest - sum(parts.values())).tolist(),
        rest_ms=rest.tolist(), scene_ms=(loop + np.append(record["wait"][1:], 0.0) * 1e3).tolist(),
    )


def data_alone_ms(argv: list[str]) -> list[float]:
    """Milliseconds of each `next` of the test loader with no workers: the
    host's work per scene (JPEG decodes, Lanczos rescales, crops)."""
    cfg = load_config(argv)
    loader_cfg = dataclasses.replace(
        cfg.data_loader, test=dataclasses.replace(cfg.data_loader.test, num_workers=0)
    )
    record = {"wait": [], "arrival": [], "end": None}
    for _ in TimedLoader(DataModule(cfg.dataset, loader_cfg).test_dataloader(), record):
        pass
    return (np.asarray(record["wait"]) * 1e3).tolist()


def spread(values: Sequence[float]) -> str:
    """Median [10th, 90th percentile] of `values`."""
    p10, p50, p90 = np.percentile(values, [10, 50, 90])
    return f"{p50:.3f} [{p10:.3f}, {p90:.3f}]"


def profile(
    copies: int,
    chunks: int,
    workdir: Path,
    checkpoint: Optional[Path] = None,
    seed: int = 0,
    overrides: Sequence[str] = (),
    device: Union[str, torch.device] = "cuda",
    runs: int = 2,
) -> dict:
    """Write the scene set (and, without `checkpoint`, a checkpoint), run the
    protocol `runs` times and the data path alone; every number of the runs."""
    t0 = time.perf_counter()
    root, index_path = write_scene_set(workdir / "re10k", copies, chunks)
    if checkpoint is None:
        subprocess.run(
            [sys.executable, "-m", "pixelsplat_tpu_torch.scripts.write_checkpoint",
             "--out", str(workdir / "checkpoints"), "--seed", str(seed)],
            check=True, stdout=subprocess.DEVNULL,
        )
        checkpoint = workdir / "checkpoints" / "step_0"
    setup_s = time.perf_counter() - t0
    base = [
        "+experiment=re10k",
        "mode=test",
        f"dataset.roots=[{root}]",
        "dataset/view_sampler=evaluation",
        f"dataset.view_sampler.index_path={index_path}",
        f"checkpointing.load={checkpoint}",
        f"seed={seed}",
        *overrides,
    ]
    results = []
    for r in range(runs):
        argv = base + [f"test.output_path={workdir / f'test_{r}'}", f"output_dir={workdir / 'outputs'}"]
        results.append(run_protocol(argv, device))
    scenes = 2 * copies
    for r, run in enumerate(results):
        s = run["summary"]
        if s["num_scenes"] != scenes or s["overflow_pairs"] != 0 or not np.isfinite([s["psnr"], s["ssim"]]).all():
            raise SystemExit(f"run {r}: {s}, expected {scenes} scenes, no dropped pairs, finite scores")
        want = scenes * run["views_per_scene"]
        if torch.device(device).type == "cuda" and run["launches"] != want:
            raise SystemExit(f"run {r}: composite_fwd launched {run['launches']} times, expected {want}")
        if run["pngs"] != want:
            raise SystemExit(f"run {r}: {run['pngs']} PNGs, expected {want}")
    return dict(
        scenes=scenes, chunks=chunks, imports_s=IMPORTS_S, setup_s=setup_s, runs=results,
        data_alone_ms=data_alone_ms(base + [f"output_dir={workdir / 'outputs'}"]),
    )


def report(result: dict, card: str) -> list[str]:
    lines = [f"{card} | {result['scenes']} scenes in {result['chunks']} chunks | imports {result['imports_s']:.3f} s "
             f"(torch and the port) | set-up {result['setup_s']:.3f} s (scene set, checkpoint; "
             f"not the protocol's)"]
    for r, run in enumerate(result["runs"]):
        rest = slice(1, None)
        lines.append(
            f"run {r} ({'fresh process' if r == 0 else 'warm process'}): main {run['wall_s']:.3f} s, to the first "
            f"batch {run['to_first_batch_s']:.3f} s, after the last scene {run['after_last_scene_s']:.3f} s, "
            f"nvcc {run['nvcc_s']:.3f} s, composite_fwd launches {run['launches']}, peak {run['peak_bytes']} bytes | "
            f"first scene: encoder {run['encoder_ms'][0]:.3f} ms, decoder {run['decoder_ms_per_view'][0]:.3f} "
            f"ms/view, rest {run['rest_ms'][0]:.3f} ms | scenes 2-{result['scenes']}, median [p10, p90] ms: "
            f"scene {spread(run['scene_ms'][rest])}, encoder {spread(run['encoder_ms'][rest])}, decoder per view "
            f"{spread(run['decoder_ms_per_view'][rest])}, data wait {spread(run['data_wait_ms'][rest])}, rest "
            f"{spread(run['rest_ms'][rest])}: copy to the device {spread(run['copy_ms'][rest])}, PSNR + SSIM "
            f"{spread(run['metrics_ms'][rest])}, PNG writes {spread(run['png_ms'][rest])}, other "
            f"{spread(run['other_ms'][rest])} | summary {run['summary']}"
        )
    lines.append(f"data path alone, no workers: first scene {result['data_alone_ms'][0]:.3f} ms, scenes 2-"
                 f"{result['scenes']} {spread(result['data_alone_ms'][1:])} ms per scene")
    return lines


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--copies", type=int, default=64, help="copies of each of the fixture's two scenes")
    parser.add_argument("--chunks", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, help="write every per-scene number here as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_protocol needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        result = profile(args.copies, args.chunks, Path(tmp), seed=args.seed)
    card = card_line()
    for line in report(result, card):
        print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, **result)))


if __name__ == "__main__":
    main()
