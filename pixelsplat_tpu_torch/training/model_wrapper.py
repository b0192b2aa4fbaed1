"""Training and evaluation entry points around the encoder and decoder.

Port of `pixelsplat_tpu/training/model_wrapper.py` for one device. Training:
`init_state`, `loss_fn`, `train_step` and `make_train_step(accumulate=)`
(encode the context views, render the target views, the configured losses,
backward, global-norm clip, Adam with warm-up). Evaluation:
`make_eval_encode`, `choose_eval_settings`, `make_eval_decode` (encode,
choose render settings for the scene from its tile occupancy, render), and
`make_eval_render` (encode and render in one call).

Where the JAX package threads an explicit parameter tree through pure
functions, the parameters here live in `self.encoder` and a train step
updates them in place; `TrainState.params` names the same tensors.

Data parallelism. Where the JAX step is one program over a device mesh
(`make_jit_train_step`: `shard_map`, a `pmean` of the gradients and of the
loss parts), each process here runs the step on its own share of the
global batch, then averages the gradients and the parts over the default
process group (`parallel/mesh.py::all_reduce_mean_`) before the clip and
Adam, so every rank applies the same update. `init_state` and
`load_state_dict` broadcast rank 0's weights (and Adam's moments on a
resume), so the replicas start equal. Without a group the step is the
one-process step.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..interop.pretrained import init_backbone_from_pretrained
from ..loss import get_losses
from ..model.decoder.decoder_splatting import DecoderSplatting, DecoderSplattingCfg
from ..model.encoder.data_shim import get_data_shim
from ..model.encoder.encoder_epipolar import EncoderEpipolar, EncoderEpipolarCfg
from ..model.types import Gaussians
from ..ops.rasterizer.adaptive import choose_settings, probe
from ..ops.rasterizer.projection import GaussiansSoA, aos_planes, soa_planes
from ..ops.rasterizer.render import RenderSettings
from ..parallel.distributed import is_rank_zero
from ..parallel.mesh import all_reduce_mean_, broadcast_
from ..utils.benchmarker import Benchmarker
from .optimizer import Optimizer, OptimizerCfg


@dataclass(frozen=True)
class TrainCfg:
    depth_mode: Optional[str] = None
    extended_visualization: bool = False
    # Recompute the encoder in the backward pass (torch.utils.checkpoint):
    # trades encoder FLOPs for activation memory.
    remat_encoder: bool = False


@dataclass(frozen=True)
class TestCfg:
    output_path: Path = Path("outputs/test")
    # Probe each scene's tile occupancy once and render at the smallest
    # sufficient capacity and pair budget (ops/rasterizer/adaptive.py)
    # instead of the static worst case. Render-exact: the probe is an upper
    # bound, and overflow stays surfaced.
    adaptive_capacity: bool = True


@dataclass(frozen=True)
class CheckpointingCfg:
    load: Optional[str] = None
    every_n_train_steps: int = 5000
    save_top_k: int = -1


@dataclass
class TrainState:
    """Parameters (the encoder's own tensors, by name), optimizer, step."""

    params: dict[str, torch.nn.Parameter]
    optimizer: Optimizer
    step: int = 0


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; a CUDA device must exist (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pixelsplat_tpu_torch runs on the GPU unless the caller "
            "passes device='cpu'"
        )
    return device


def effective_accumulate(per_rank_batch: int, accumulate: int) -> int:
    """`accumulate` where it divides the per-rank batch, else its largest
    divisor that is at most `accumulate` (the JAX `make_jit_train_step`'s
    rule: a data-parallel split already shrinks each rank's batch, so the
    re10k recipe's batch 7 accumulates 7 times on one card and not at all
    on 7)."""
    if per_rank_batch % accumulate == 0:
        return accumulate
    eff = max(d for d in range(1, per_rank_batch + 1) if per_rank_batch % d == 0 and d <= accumulate)
    print(f"accumulate_grad_batches={accumulate} does not divide per-device batch {per_rank_batch}; using {eff}")
    return eff


def _slice_batch(batch: dict, lo: int, hi: int) -> dict:
    """Batch elements lo..hi of every leaf of a nested batch dict."""
    return {
        k: _slice_batch(v, lo, hi) if isinstance(v, dict) else v[lo:hi] for k, v in batch.items()
    }


def batch_to(batch: dict, device: torch.device) -> dict:
    """Nested dict of arrays/tensors -> tensors on `device`, floats as float32."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out[key] = batch_to(value, device)
            continue
        value = torch.as_tensor(value)
        if value.is_floating_point():
            value = value.float()
        out[key] = value.to(device)
    return out


class ModelWrapper:
    """Holds the encoder (on `device`; it has no layer that behaves
    differently in training mode), the decoder, the encoder's data shim
    and, for training, the losses and optimizer settings."""

    def __init__(
        self,
        encoder_cfg: EncoderEpipolarCfg,
        decoder_cfg: DecoderSplattingCfg,
        device: Union[str, torch.device] = "cuda",
        optimizer_cfg: OptimizerCfg = OptimizerCfg(),
        train_cfg: TrainCfg = TrainCfg(),
        loss_cfgs: Sequence = (),
        gradient_clip_val: float = 0.5,
        test_cfg: TestCfg = TestCfg(),
    ):
        self.device = resolve_device(device)
        self.encoder_cfg = encoder_cfg
        self.encoder = EncoderEpipolar(encoder_cfg).to(self.device).eval()
        self.data_shim = get_data_shim(encoder_cfg)
        self.decoder = DecoderSplatting(decoder_cfg)
        self.optimizer_cfg = optimizer_cfg
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.gradient_clip_val = gradient_clip_val
        self.losses = get_losses(list(loss_cfgs), device=self.device)

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """A fresh optimizer over the encoder's current weights, at step 0.

        The backbone's pretrained trunks are copied in first when their
        exported weights are on disk (`interop/pretrained.py`), as the JAX
        `init_state` grafts them; in a process group every rank then takes
        rank 0's weights."""
        n_grafted = init_backbone_from_pretrained(self.encoder, self.encoder_cfg)
        if is_rank_zero():
            if n_grafted:
                print(f"initialized {n_grafted} backbone tensors from pretrained DINO weights")
            else:
                print("no pretrained DINO weights on disk: the backbone keeps its initialization")
        params = dict(self.encoder.named_parameters())
        if dist.is_initialized():
            with torch.no_grad():
                broadcast_(params.values(), src=0)
        optimizer = Optimizer(params.values(), self.optimizer_cfg, self.gradient_clip_val)
        return TrainState(params=params, optimizer=optimizer, step=0)

    def state_dict(self, state: TrainState) -> dict:
        """What a checkpoint holds: parameters, optimizer state and step."""
        return {
            "params": self.encoder.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
        }

    def load_state_dict(self, state: TrainState, payload: dict) -> TrainState:
        """Restore a checkpoint; in a process group, every rank then takes
        rank 0's weights and Adam moments (Adam's step counts, host
        tensors, come from the same checkpoint on every rank)."""
        self.encoder.load_state_dict(payload["params"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        if dist.is_initialized():
            adam = state.optimizer.adam.state
            tensors = list(state.params.values()) + [
                v for p in state.params.values() for v in adam.get(p, {}).values()
                if torch.is_tensor(v) and v.device == p.device
            ]
            with torch.no_grad():
                broadcast_(tensors, src=0)
        return state

    def loss_fn(
        self,
        batch: dict,
        step: int,
        generator: Optional[torch.Generator] = None,
        u: Optional[torch.Tensor] = None,
        view_order: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(total loss, parts) of one batch at the encoder's current weights.

        The depth-sampling uniforms come from `u` ((b, v, h*w, surfaces,
        gpp)) and, with more than two context views, the order of the
        epipolar transformer's view embeddings from `view_order` (a
        permutation of v-1) when given, else from `generator`; both are
        drawn here, before the encoder, so a rematerialized encoder sees
        the same draws.
        """
        batch = self.data_shim(batch_to(batch, self.device))
        context, target = batch["context"], batch["target"]
        b, v, _, ch, cw = context["image"].shape
        h, w = target["image"].shape[-2:]
        cfg = self.encoder_cfg
        if u is None:
            u = torch.rand(
                (b, v, ch * cw, cfg.num_surfaces, cfg.gaussians_per_pixel),
                generator=generator, device=self.device,
            )

        if view_order is None and v > 2 and cfg.use_epipolar_transformer:
            view_order = torch.randperm(v - 1, generator=generator, device=self.device)

        def encode(context, u):
            return self.encoder(context, step, False, u=u.to(self.device), view_order=view_order)

        if self.train_cfg.remat_encoder:
            gaussians = checkpoint(encode, context, u, use_reentrant=False)
        else:
            gaussians = encode(context, u)
        output = self.decoder(
            gaussians, target["extrinsics"], target["intrinsics"], target["near"], target["far"],
            (h, w), depth_mode=self.train_cfg.depth_mode,
        )
        total = output.color.new_zeros(())
        parts = {}
        for loss in self.losses:
            value = loss(output, batch, gaussians, step)
            parts[f"loss/{loss.name}"] = value.detach()
            total = total + value
        with torch.no_grad():
            mse = ((output.color - target["image"]) ** 2).mean()
            parts["train/psnr_probabilistic"] = -10.0 * torch.log10(mse)
            # Pairs the binner dropped at tile capacity: non-zero means
            # Gaussians missing from the rendered views.
            parts["train/overflow_pairs"] = output.overflow.float()
        parts["loss/total"] = total.detach()
        return total, parts

    def train_step(self, state: TrainState, batch: dict, generator=None, u=None):
        return self.make_train_step()(state, batch, generator=generator, u=u)

    def make_train_step(
        self,
        accumulate: int = 1,
        benchmarker: Optional[Benchmarker] = None,
        group: Optional[dist.ProcessGroup] = None,
    ) -> Callable:
        """`step_fn(state, batch, generator=None, u=None)` -> (state, parts).

        One optimizer update: gradients of `loss_fn`, global-norm clip, Adam
        at the scheduled rate; the weights and `state` change in place.
        `accumulate` > 1 splits the batch into that many micro-batches along
        its first axis and applies one update to the mean of their
        gradients; every loss term is a per-example mean, so that equals the
        large batch's gradient, and clip and Adam see only the mean.

        In a process group (`group`, else the default group when one
        exists) `batch` is this rank's share of the global batch: the
        rank's mean gradient and its loss parts are averaged over the group
        (`all_reduce_mean_`) before the clip, so every rank applies the same
        update and returns the global batch's parts. `step_fn.reduced_bytes`
        holds the bytes the last all-reduce moved.

        With a `benchmarker`, each micro-batch's forward and backward, the
        all-reduce and the optimizer's update are timed on the device clock
        (`Benchmarker.time_device`: "forward", "backward", "all_reduce",
        "optimizer").
        """
        timed = benchmarker.time_device if benchmarker is not None else (lambda tag: nullcontext())

        def step_fn(state, batch, generator=None, u=None):
            params = list(state.params.values())
            for p in params:
                p.grad = None
            size = next(iter(batch["context"].values())).shape[0]
            if size % accumulate:
                raise ValueError(f"accumulate={accumulate} does not divide the batch of {size}")
            micro = size // accumulate
            parts = None
            for i in range(accumulate):
                lo, hi = i * micro, (i + 1) * micro
                with timed("forward"):
                    total, mb_parts = self.loss_fn(
                        _slice_batch(batch, lo, hi), state.step, generator, None if u is None else u[lo:hi]
                    )
                with timed("backward"):
                    total.backward()  # adds into .grad
                parts = mb_parts if parts is None else {k: parts[k] + v for k, v in mb_parts.items()}
            for p in params:
                if p.grad is None:  # a weight the loss does not reach
                    p.grad = torch.zeros_like(p)
            if accumulate > 1:
                inv = 1.0 / accumulate
                torch._foreach_mul_([p.grad for p in params], inv)
                parts = {k: v * inv for k, v in parts.items()}
            if dist.is_initialized() or group is not None:
                names = list(parts)
                packed = torch.stack([parts[k].float() for k in names])
                with timed("all_reduce"):
                    step_fn.reduced_bytes = all_reduce_mean_([p.grad for p in params] + [packed], group)
                parts = dict(zip(names, packed.unbind()))
            with timed("optimizer"):
                state.optimizer.step(state.step)
            state.step += 1
            return state, parts

        step_fn.reduced_bytes = 0
        return step_fn

    # ------------------------------------------------------------------
    def make_eval_render(self) -> Callable:
        """`render_fn(batch, step, generator=None, u=None)` -> (color (b, v,
        3, h, w), overflow): the test protocol's encode and render in one
        call. The encoder is the probabilistic one (3 Gaussians per pixel in
        the production config), as the published metrics use, and the
        target views render at the decoder's static settings."""
        encode_fn = self.make_eval_encode()
        decode_fn = self.make_eval_decode()

        def render_fn(batch: dict, step: int, generator: Optional[torch.Generator] = None,
                      u: Optional[torch.Tensor] = None):
            gaussians = encode_fn(batch, False, step, generator=generator, u=u)
            target = self.data_shim(batch_to(batch, self.device))["target"]
            h, w = target["image"].shape[-2:]
            return decode_fn(
                gaussians, target["extrinsics"], target["intrinsics"], target["near"], target["far"], (h, w)
            )

        return render_fn

    def make_eval_encode(self, pack_soa: bool = False) -> Callable:
        """`encode_fn(batch, deterministic, step, generator=None, u=None)`.

        Runs the data shim and the encoder without autograd. `pack_soa=True`
        emits the scene in the rasterizer's SoA layout, for callers that
        only render. The depth samples come from `u` when given, else from
        `generator`.
        """

        @torch.no_grad()
        def encode_fn(
            batch: dict,
            deterministic: bool,
            step: int,
            generator: Optional[torch.Generator] = None,
            u: Optional[torch.Tensor] = None,
            view_order: Optional[torch.Tensor] = None,
        ) -> Union[Gaussians, GaussiansSoA]:
            batch = self.data_shim(batch_to(batch, self.device))
            return self.encoder(
                batch["context"], step, deterministic, pack_soa=pack_soa, u=u, generator=generator,
                view_order=view_order,
            )

        return encode_fn

    def choose_eval_settings(
        self,
        gaussians: Union[Gaussians, GaussiansSoA],
        extrinsics: torch.Tensor,  # (b, v, 4, 4)
        intrinsics: torch.Tensor,  # (b, v, 3, 3)
        near: torch.Tensor,  # (b, v)
        image_shape: tuple[int, int],
    ) -> RenderSettings:
        """Occupancy-adaptive render settings for batch element 0's views
        (two reads back from the device per scene, `probe`)."""
        if isinstance(gaussians, GaussiansSoA):
            planes = soa_planes(GaussiansSoA(*(None if x is None else x[0] for x in gaussians)))
        else:
            planes = aos_planes(gaussians.means[0], gaussians.covariances[0], gaussians.opacities[0])
        settings = self.decoder.cfg.render
        with torch.no_grad():
            occupancy = probe(
                extrinsics[0].to(self.device),
                intrinsics[0].to(self.device),
                near[0].to(self.device),
                planes,
                image_shape,
                settings,
            )
        return choose_settings(occupancy, settings, planes[0].shape[-1], image_shape)

    def make_eval_decode(self) -> Callable:
        """`decode_fn(gaussians, extrinsics, intrinsics, near, far,
        image_shape, render_settings=None)` -> (color (b, v, 3, h, w),
        overflow)."""

        @torch.no_grad()
        def decode_fn(
            gaussians,
            extrinsics,
            intrinsics,
            near,
            far,
            image_shape,
            render_settings: Optional[RenderSettings] = None,
        ):
            output = self.decoder(
                gaussians,
                extrinsics.to(self.device),
                intrinsics.to(self.device),
                near.to(self.device),
                far.to(self.device),
                image_shape,
                render_settings=render_settings,
            )
            return output.color, output.overflow

        return decode_fn
