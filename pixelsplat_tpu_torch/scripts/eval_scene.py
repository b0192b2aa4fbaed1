"""The evaluation scene with random weights, and the timing helpers that
`chip_smoke.py` and `profile_scene.py` share.

    python -m pixelsplat_tpu_torch.scripts.eval_scene [--model NAME]

The model is one of `config.EXPERIMENTS` at full width (`re10k`, the
production model with the epipolar transformer, unless named otherwise),
or `default` (the encoder that `config/main.yaml` composes with no
experiment: the resnet50 InstanceNorm backbone); the scene is `bench.py`'s:
two 256x256 context views 0.8 apart along x (three views of
`re10k_3_view` at x = 0, 0.4, 0.8, the evaluation sampler's midpoint
second), three target views at x = -0.3, 0, 0.3, normalized intrinsics
with focal 1.
The weights and images come from a seeded `torch.Generator`. Run as a
script (on a CUDA device) it encodes, chooses settings and renders once,
checks the result, and prints encode and render times from CUDA events
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import math
import subprocess
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..config import EXPERIMENTS, default_model
from ..model.encoder.encoder_epipolar import EncoderEpipolarCfg
from ..ops.rasterizer.composite import pack_columns
from ..ops.rasterizer.projection import GaussiansSoA
from ..ops.rasterizer.render import RenderSettings, project_and_bin
from ..training.model_wrapper import ModelWrapper

TARGET_VIEWS = 3
# Context views along x by their number.
CONTEXT_SHIFTS = {2: (0.0, 0.8), 3: (0.0, 0.4, 0.8)}
MODELS = sorted(EXPERIMENTS) + ["default"]


def model_cfgs(model: str):
    """(encoder cfg, decoder cfg) of an experiment or of `default`."""
    return default_model() if model == "default" else EXPERIMENTS[model][0]()


def num_gaussians(cfg: EncoderEpipolarCfg, image_shape: tuple[int, int]) -> int:
    """Gaussians a probabilistic encode of the configuration gives:
    views x pixels x surfaces x Gaussians per pixel."""
    h, w = image_shape
    return cfg.num_context_views * h * w * cfg.num_surfaces * cfg.gaussians_per_pixel


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn: Callable, iters: int = 5, warmup: int = 2) -> float:
    """Mean milliseconds per call of `fn` on the device, from CUDA events
    around `iters` calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def view_inputs(scene: "EvalScene", gaussians, settings: RenderSettings) -> list:
    """Per target view, (projected Gaussians, tile lists, parameter table):
    the compositing kernel's inputs as the decoder builds them."""
    soa = GaussiansSoA(*(None if x is None else x[0] for x in gaussians))
    t = scene.target
    out = []
    for v in range(TARGET_VIEWS):
        projected, tiles = project_and_bin(
            t["extrinsics"][0, v], t["intrinsics"][0, v], t["near"][0, v], soa,
            image_shape=scene.image_shape, settings=settings,
        )
        out.append((projected, tiles, pack_columns(projected).contiguous()))
    return out


def init_random_weights(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Fan-in scaled normals for matrices and kernels, zero biases, unit
    norm scales, identity BatchNorm statistics, a 0.02 normal position
    embedding, zero class token."""
    with torch.no_grad():
        for name, x in module.state_dict().items():
            if name.endswith("pos_embed"):
                x.copy_(torch.randn(x.shape, generator=generator, device=x.device) * 0.02)
            elif name.endswith("running_var") or (name.endswith("weight") and x.ndim == 1):
                x.fill_(1.0)
            elif x.ndim >= 2 and not name.endswith("cls_token"):
                fan_in = math.prod(x.shape[1:])
                x.copy_(torch.randn(x.shape, generator=generator, device=x.device) / math.sqrt(fan_in))
            else:
                x.zero_()


def scene_batch(
    device, generator: torch.Generator, h: int, w: int,
    target_shifts=(-0.3, 0.0, 0.3), batch: int = 1, context_shifts=CONTEXT_SHIFTS[2],
) -> dict:
    """`batch` examples of one context view per entry of `context_shifts`
    (two 0.8 apart along x by default) and one target view per entry of
    `target_shifts`, with random images."""
    k = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], device=device)

    def views(shifts):
        v = len(shifts)
        extr = torch.eye(4, device=device).repeat(batch, v, 1, 1)
        extr[:, :, 0, 3] = torch.tensor(shifts, device=device)
        return {
            "image": torch.rand((batch, v, 3, h, w), generator=generator, device=device),
            "extrinsics": extr,
            "intrinsics": k.repeat(batch, v, 1, 1),
            "near": torch.ones((batch, v), device=device),
            "far": torch.full((batch, v), 100.0, device=device),
        }

    return {"context": views(list(context_shifts)), "target": views(list(target_shifts))}


@dataclass
class EvalScene:
    wrapper: ModelWrapper
    batch: dict  # raw batch (before the data shim)
    target: dict  # shimmed target views (cameras with near/far)
    image_shape: tuple[int, int]
    encode: Callable
    decode: Callable

    def choose(self, gaussians) -> RenderSettings:
        t = self.target
        return self.wrapper.choose_eval_settings(
            gaussians, t["extrinsics"], t["intrinsics"], t["near"], self.image_shape
        )

    def render(self, gaussians, settings: RenderSettings):
        t = self.target
        return self.decode(
            gaussians, t["extrinsics"], t["intrinsics"], t["near"], t["far"], self.image_shape, settings
        )

    def run(self, seed: int):
        """Encode (probabilistic, SoA) -> choose settings -> render."""
        device = self.wrapper.device
        gaussians = self.encode(
            self.batch, False, 0, generator=torch.Generator(device=device).manual_seed(seed)
        )
        settings = self.choose(gaussians)
        color, overflow = self.render(gaussians, settings)
        return gaussians, settings, color, overflow


def make_eval_scene(
    device="cuda",
    seed: int = 0,
    image_shape: tuple[int, int] = (256, 256),
    encoder_cfg: Optional[EncoderEpipolarCfg] = None,
    model: str = "re10k",
) -> EvalScene:
    """The scene of experiment `model` (or `default`; its encoder replaced
    by `encoder_cfg` when given), with seeded random weights, on `device`."""
    model_encoder, decoder_cfg = model_cfgs(model)
    encoder_cfg = encoder_cfg or model_encoder
    wrapper = ModelWrapper(encoder_cfg, decoder_cfg, device=device)
    generator = torch.Generator(device=wrapper.device).manual_seed(seed)
    init_random_weights(wrapper.encoder, generator)
    batch = scene_batch(
        wrapper.device, generator, *image_shape, context_shifts=CONTEXT_SHIFTS[encoder_cfg.num_context_views]
    )
    return EvalScene(
        wrapper=wrapper,
        batch=batch,
        target=wrapper.data_shim(batch)["target"],
        image_shape=image_shape,
        encode=wrapper.make_eval_encode(pack_soa=True),
        decode=wrapper.make_eval_decode(),
    )


def main() -> None:
    parser = argparse.ArgumentParser(description="Run the evaluation scene once on the GPU and time it.")
    parser.add_argument("--model", default="re10k", choices=MODELS)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("eval_scene needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    scene = make_eval_scene(seed=args.seed, model=args.model)
    scene.run(args.seed + 1)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    gaussians, settings, color, overflow = scene.run(args.seed)
    torch.cuda.synchronize()
    if gaussians.mean_x.shape[1] != num_gaussians(scene.wrapper.encoder_cfg, scene.image_shape) or int(
        overflow
    ) or not bool(torch.isfinite(color).all()):
        raise SystemExit(f"FAIL: {gaussians.mean_x.shape[1]} Gaussians, overflow {int(overflow)}, or non-finite images")
    encode_ms = cuda_ms(lambda: scene.encode(scene.batch, False, 0))
    render_ms = cuda_ms(lambda: scene.render(gaussians, settings)) / TARGET_VIEWS
    print(f"{args.model}: {gaussians.mean_x.shape[1]} Gaussians, images {tuple(color.shape)}, overflow 0, "
          f"capacity {settings.capacity}, pair_budget {settings.pair_budget}")
    print(f"{card} | encode {encode_ms:.3f} ms | render {render_ms:.3f} ms/view | "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
