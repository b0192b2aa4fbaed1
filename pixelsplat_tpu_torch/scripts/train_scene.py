"""The model's training step with random weights: a seeded batch and a
helper that takes a few steps, shared by `chip_smoke.py` and
`profile_scene.py --train`.

    python -m pixelsplat_tpu_torch.scripts.train_scene [--model NAME] [--steps N]

The model is one of `config.EXPERIMENTS` at full width (`re10k` unless
named otherwise) with its training configuration (MSE + LPIPS, Adam with
warm-up, clip 0.5; for `re10k` the encoder rematerialized); a batch holds two 256x256 context views and four target views per example,
as the re10k view sampler gives the trainer. The published LPIPS weights
are not in the repository, so the LPIPS network takes architecture-correct
random weights (`allow_random_weights`).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from ..config import EXPERIMENTS, NUM_TARGET_VIEWS, TrainingCfg
from ..loss import LossLpipsCfg
from ..model.encoder.encoder_epipolar import EncoderEpipolarCfg
from ..ops.rasterizer.composite import assemble_image, pack_columns
from ..ops.rasterizer.composite_kernel import composite_core
from ..ops.rasterizer.projection import pack_gaussians_soa
from ..ops.rasterizer.render import DepthRenderingMode, depth_colors, project_and_bin
from ..training.model_wrapper import ModelWrapper, TrainState, batch_to
from .eval_scene import init_random_weights, scene_batch

TARGET_SHIFTS = (-0.3, 0.1, 0.4, 0.9)
assert len(TARGET_SHIFTS) == NUM_TARGET_VIEWS


@dataclass
class TrainScene:
    wrapper: ModelWrapper
    training: TrainingCfg
    state: TrainState
    image_shape: tuple[int, int]
    seed: int

    def batch(self, size: int = 1, seed_offset: int = 0) -> dict:
        generator = torch.Generator(device=self.wrapper.device).manual_seed(self.seed + 100 + seed_offset)
        return scene_batch(
            self.wrapper.device, generator, *self.image_shape, target_shifts=TARGET_SHIFTS, batch=size
        )

    def steps(self, n: int, batch: dict, accumulate: int = 1, step_fn: Optional[Callable] = None) -> list[dict]:
        """Take `n` optimizer steps on `batch`; returns each step's parts."""
        step_fn = step_fn or self.wrapper.make_train_step(accumulate=accumulate)
        generator = torch.Generator(device=self.wrapper.device).manual_seed(self.seed + 200 + self.state.step)
        out = []
        for _ in range(n):
            self.state, parts = step_fn(self.state, batch, generator=generator)
            out.append(parts)
        return out


def make_train_scene(
    device="cuda",
    seed: int = 0,
    image_shape: tuple[int, int] = (256, 256),
    encoder_cfg: Optional[EncoderEpipolarCfg] = None,
    remat_encoder: Optional[bool] = None,
    model: str = "re10k",
) -> TrainScene:
    """The training scene of experiment `model`; `remat_encoder` overrides
    the experiment's own setting when given."""
    model_cfg, training_cfg = EXPERIMENTS[model]
    default_encoder, decoder_cfg = model_cfg()
    training = training_cfg()
    losses = tuple(
        dataclasses.replace(c, allow_random_weights=True) if isinstance(c, LossLpipsCfg) else c
        for c in training.loss
    )
    train = training.train
    if remat_encoder is not None:
        train = dataclasses.replace(train, remat_encoder=remat_encoder)
    training = dataclasses.replace(training, loss=losses, train=train)
    wrapper = ModelWrapper(
        encoder_cfg or default_encoder, decoder_cfg, device=device,
        optimizer_cfg=training.optimizer, train_cfg=training.train, loss_cfgs=training.loss,
        gradient_clip_val=training.gradient_clip_val,
    )
    init_random_weights(wrapper.encoder, torch.Generator(device=wrapper.device).manual_seed(seed))
    return TrainScene(
        wrapper=wrapper, training=training, state=wrapper.init_state(), image_shape=image_shape, seed=seed
    )


def backward_inputs(
    scene: TrainScene, batch: dict, seed: int = 0, depth_mode: Optional[DepthRenderingMode] = None
) -> list[dict]:
    """Per target view of `batch`'s first example, the backward compositing
    kernel's inputs as a training step at the current weights builds them:
    the table and tile lists under the decoder's static settings, the
    forward kernel's `n_proc` and `trans`, and the cotangents of `acc` and
    `trans` that the MSE over all target views sends back. With a
    `depth_mode`, those of the view's depth render instead (one colour
    channel, `render_depth`), with the cotangents that the wrapper's depth
    loss on that view's depth map sends back."""
    wrapper = scene.wrapper
    settings = wrapper.decoder.cfg.render
    shimmed = wrapper.data_shim(batch_to(batch, wrapper.device))
    target = shimmed["target"]
    h, w = target["image"].shape[-2:]
    with torch.no_grad():
        gaussians = wrapper.encoder(
            shimmed["context"], scene.state.step, False,
            generator=torch.Generator(device=wrapper.device).manual_seed(seed),
        )
    means, covs, opacities = gaussians.means[0], gaussians.covariances[0], gaussians.opacities[0]
    soa = pack_gaussians_soa(means, covs, opacities, harmonics=gaussians.harmonics[0])
    background = torch.tensor(wrapper.decoder.cfg.background_color, device=wrapper.device)
    if depth_mode is not None:
        background = background.new_zeros(1)
        depth_loss = next(loss for loss in wrapper.losses if loss.name == "depth")
    tiles_x = -(-w // settings.tile_size)
    out = []
    for v in range(target["image"].shape[1]):
        e, n, f = target["extrinsics"][0, v], target["near"][0, v], target["far"][0, v]
        with torch.no_grad():
            if depth_mode is not None:
                colors = depth_colors(e[None], n[None], f[None], means[None], depth_mode)[0]
                soa = pack_gaussians_soa(means, covs, opacities, colors_precomp=colors[:, None])
            projected, tiles = project_and_bin(
                e, target["intrinsics"][0, v], n, soa, image_shape=(h, w), settings=settings
            )
            table = pack_columns(projected).contiguous()
            acc, trans, n_proc = composite_core(
                table, tiles.flat, tiles.block_start, tiles.counts, tiles_x, settings.chunk, settings.tile_size
            )
        acc.requires_grad_()
        trans.requires_grad_()
        image = assemble_image(acc, trans, background, (h, w), settings.tile_size)
        if depth_mode is None:
            loss = ((image - target["image"][0, v]) ** 2).sum().div(target["image"][0].numel())
        else:
            view = {"target": {"image": target["image"][:1, v : v + 1]}}
            loss = depth_loss(SimpleNamespace(depth=image[None]), view, None, scene.state.step)
        loss.backward()
        out.append(dict(
            table=table, tiles=tiles, n_proc=n_proc, trans=trans.detach(), g_acc=acc.grad,
            g_trans=trans.grad, tiles_x=tiles_x, chunk=settings.chunk,
        ))
    return out


def timed_step(scene: TrainScene, batch: dict) -> dict[str, float]:
    """One training step with CUDA events between its forward, backward and
    optimizer update: milliseconds of each on the device's clock."""
    state = scene.state
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    generator = torch.Generator(device=scene.wrapper.device).manual_seed(scene.seed + 300)
    for p in state.params.values():
        p.grad = None
    marks[0].record()
    total, _ = scene.wrapper.loss_fn(batch, state.step, generator)
    marks[1].record()
    total.backward()
    marks[2].record()
    state.optimizer.step(state.step)
    state.step += 1
    marks[3].record()
    torch.cuda.synchronize()
    names = ("forward_ms", "backward_ms", "optimizer_ms")
    return {n: marks[i].elapsed_time(marks[i + 1]) for i, n in enumerate(names)}


def main() -> None:
    parser = argparse.ArgumentParser(description="Take a few training steps on the GPU and print their parts.")
    parser.add_argument("--model", default="re10k", choices=sorted(EXPERIMENTS))
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--accumulate", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_scene needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = make_train_scene(model=args.model)
    for i, parts in enumerate(scene.steps(args.steps, scene.batch(args.batch), accumulate=args.accumulate)):
        print(f"step {i}: " + ", ".join(f"{k} {float(v):.6g}" for k, v in parts.items()))
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
