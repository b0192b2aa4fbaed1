"""Data-parallel training and view-sharded rendering across processes.

    python -m pixelsplat_tpu_torch.scripts.distributed_step --out DIR [--world 2] [--backend gloo|nccl]

Starts `--world` ranks on this machine (rank r on card r % cards, so two
ranks share one card), joined through a `FileStore` at `DIR/store`. Every
rank builds `--model` (`re10k`) at full width with the same seeded weights
(`train_scene.make_train_scene`) and then:
1. encodes the evaluation scene of `eval_scene.make_eval_scene` (2 context
   views, 393,216 Gaussians, SoA), takes rank 0's Gaussians (broadcast),
   chooses its render settings and renders its 3 target views with
   `parallel.render.render_views_sharded` (padded to a multiple of the
   world size);
2. takes one training step from step 0 on its example of a global batch of
   `world` (2 context and 4 target views at 256x256, each example with its
   own uniforms), the gradients averaged over the group, then a second,
   timed, step.
Rank 0 writes the Gaussians, settings and views to `DIR/render.pt` and its
weights and averaged gradients after the first step to `DIR/step.pt`; each
rank writes its numbers to `DIR/rank<r>.json`. The launcher then takes the
same global batch as `world` accumulated micro-batches in one process and
renders the same views with the plain decoder, and prints both
comparisons. `chip_smoke.py` runs it as its `[distributed]` phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parents[2]


def global_inputs(scene, world: int, seed: int) -> tuple[dict, torch.Tensor]:
    """The global batch of `world` examples and their uniforms, the same in
    every process."""
    wrapper = scene.wrapper
    batch = scene.batch(world)
    cfg = wrapper.encoder_cfg
    h, w = scene.image_shape
    v = cfg.num_context_views
    generator = torch.Generator(device=wrapper.device).manual_seed(seed + 400)
    u = torch.rand((world, v, h * w, cfg.num_surfaces, cfg.gaussians_per_pixel), generator=generator,
                   device=wrapper.device)
    return batch, u


def eval_batch(scene, seed: int) -> dict:
    """`eval_scene.make_eval_scene(seed)`'s batch: its generator draws the
    weights (the scene's own, unchanged by the redraw) and then the views."""
    from .eval_scene import CONTEXT_SHIFTS, init_random_weights, scene_batch

    wrapper = scene.wrapper
    generator = torch.Generator(device=wrapper.device).manual_seed(seed)
    init_random_weights(wrapper.encoder, generator)
    return scene_batch(wrapper.device, generator, *scene.image_shape,
                       context_shifts=CONTEXT_SHIFTS[wrapper.encoder_cfg.num_context_views])


def launches() -> dict:
    from ..utils import tracing

    return {"composite_fwd": tracing.counter("k1_launches"), "composite_bwd": tracing.counter("k2_launches")}


def reset_launches() -> None:
    from ..utils import tracing

    tracing.reset()


def rank_main(args) -> None:
    import torch.distributed as dist

    from ..parallel import distributed
    from ..parallel.mesh import broadcast_, rank_slice, shard_batch
    from ..parallel.render import render_views_sharded
    from ..utils.benchmarker import Benchmarker
    from .train_scene import make_train_scene

    rank, world = distributed.maybe_initialize("cuda", backend=args.backend)
    device = distributed.local_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(args.out)
    scene = make_train_scene(device=device, seed=args.seed, model=args.model)
    wrapper = scene.wrapper
    result = dict(rank=rank, world=world, backend=dist.get_backend(), device=str(device))

    # 1. The evaluation scene's views, split over the ranks.
    batch = eval_batch(scene, args.seed)
    gaussians = wrapper.make_eval_encode(pack_soa=True)(
        batch, False, 0, generator=torch.Generator(device=device).manual_seed(args.seed))
    broadcast_([x for x in gaussians if x is not None], src=0)
    target = wrapper.data_shim(batch)["target"]
    cameras = (target["extrinsics"], target["intrinsics"], target["near"], target["far"])
    settings = wrapper.choose_eval_settings(gaussians, *cameras[:3], scene.image_shape)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        output = render_views_sharded(wrapper.decoder, gaussians, *cameras, scene.image_shape,
                                      render_settings=settings)
    torch.cuda.synchronize()
    result.update(render_ms=1e3 * (time.perf_counter() - t0), render_launches=launches(),
                  render_overflow=int(output.overflow), render_views=list(output.color.shape))
    if rank == 0:
        torch.save(dict(gaussians=gaussians, cameras=cameras, settings=settings, color=output.color,
                        image_shape=scene.image_shape), out / "render.pt")
    del gaussians, output

    # 2. One data-parallel step from step 0, then a second one, timed.
    global_batch, u = global_inputs(scene, world, args.seed)
    mine, u_mine = shard_batch(global_batch, rank, world), u[rank_slice(world, rank, world)]
    bench = Benchmarker(device)
    step_fn = wrapper.make_train_step(benchmarker=bench)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, parts = step_fn(scene.state, mine, u=u_mine)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    result.update(step_launches=launches(), parts={k: float(v) for k, v in parts.items()},
                  reduced_bytes=step_fn.reduced_bytes)
    flat = torch.cat([p.detach().reshape(-1) for p in state.params.values()])
    theirs = flat.clone()
    dist.broadcast(theirs, src=0)
    result["replica_equal_to_rank0"] = bool(torch.equal(flat, theirs))
    del flat, theirs
    if rank == 0:
        torch.save(dict(params={k: p.detach() for k, p in state.params.items()},
                        grads={k: p.grad for k, p in state.params.items()}), out / "step.pt")
    first = bench.summarize()
    bench.clear_history()
    dist.barrier()  # rank 0's file written: the timed step starts together
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step_fn(state, mine, u=u_mine)
    torch.cuda.synchronize()
    second_ms = 1e3 * (time.perf_counter() - t0)
    second = bench.summarize()
    result.update(
        step_ms=[first_ms, second_ms],
        parts_ms={k: [1e3 * first[k], 1e3 * second[k]] for k in second},
        peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
    )
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    distributed.destroy()


def launch(out: Path, world: int = 2, backend: str = "gloo", seed: int = 0, model: str = "re10k",
           timeout: float = 600.0) -> list[dict]:
    """Run `world` ranks to their end; returns each rank's numbers. A rank
    that fails stops the others."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    for stale in [out / "store", *out.glob("rank*.json"), out / "step.pt", out / "render.pt"]:
        stale.unlink(missing_ok=True)
    cards = max(torch.cuda.device_count(), 1)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "PIXELSPLAT_DISTRIBUTED")}
    env.update(PYTHONPATH=str(ROOT), PIXELSPLAT_COORDINATOR=f"file://{(out / 'store').resolve()}",
               PIXELSPLAT_NUM_PROCESSES=str(world))
    argv = [sys.executable, "-m", "pixelsplat_tpu_torch.scripts.distributed_step", "--out", str(out),
            "--world", str(world), "--backend", backend, "--seed", str(seed), "--model", model]
    procs = [
        subprocess.Popen(argv + ["--rank", str(r)], cwd=ROOT,
                         env={**env, "PIXELSPLAT_PROCESS_ID": str(r), "LOCAL_RANK": str(r % cards)},
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    logs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = "\n".join(f"--- rank {r}:\n{logs[r][-3000:] if r < len(logs) else ''}" for r in failed)
        raise RuntimeError(f"rank(s) {failed} failed:\n{tails}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def one_process(out: Path, world: int = 2, seed: int = 0, model: str = "re10k") -> dict:
    """In this process: the ranks' global batch as `world` accumulated
    micro-batches from the same weights and uniforms, against rank 0's
    weights and gradients; the evaluation scene's views through the plain
    decoder on rank 0's Gaussians, against the sharded render."""
    from ..model.decoder.decoder_splatting import DecoderSplatting
    from .train_scene import make_train_scene

    out = Path(out)
    scene = make_train_scene(device="cuda", seed=seed, model=model)
    wrapper = scene.wrapper
    render = torch.load(out / "render.pt", map_location="cuda", weights_only=False)
    decoder = DecoderSplatting(wrapper.decoder.cfg)
    with torch.no_grad():
        want = decoder(render["gaussians"], *render["cameras"], render["image_shape"],
                       render_settings=render["settings"])
    render_result = dict(
        equal=bool(torch.equal(want.color, render["color"])),
        max_abs_err=float((want.color - render["color"]).abs().max()),
        overflow=int(want.overflow), shape=list(want.color.shape),
    )
    del render, want
    batch, u = global_inputs(scene, world, seed)
    state, parts = wrapper.make_train_step(accumulate=world)(scene.state, batch, u=u)
    ranks = torch.load(out / "step.pt", map_location="cuda", weights_only=False)
    param_err = max(float((ranks["params"][k] - p.detach()).abs().max()) for k, p in state.params.items())
    grad_rel = max(
        float((ranks["grads"][k] - p.grad).abs().max()) / max(float(p.grad.abs().max()), 1e-30)
        for k, p in state.params.items()
    )
    return dict(render=render_result, parts={k: float(v) for k, v in parts.items()}, param_max_abs_err=param_err,
                grad_max_rel_err=grad_rel, tensors=len(state.params),
                step0_lr=state.optimizer.adam.param_groups[0]["lr"])


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--model", default="re10k")
    parser.add_argument("--rank", type=int, default=None, help="run as this rank (the launcher passes it)")
    args = parser.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return
    if not torch.cuda.is_available():
        raise SystemExit("distributed_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for result in launch(args.out, args.world, args.backend, args.seed, args.model):
        print(json.dumps(result))
    print(json.dumps(one_process(args.out, args.world, args.seed, args.model)))


if __name__ == "__main__":
    main()
