"""The JAX package's parameter trees -> the port's `state_dict`s.

The inverse of `pixelsplat_tpu/interop/torch_import.py::convert_encoder`:
the DINO backbone or a ResNet one (the torchvision trunks, whose
InstanceNorm has no parameters, or the frozen-BatchNorm `dino_resnet50`),
with or without the epipolar transformer, and `to_opacity`. Input is the Flax parameter tree as nested dicts of numpy arrays (what
`jax.device_get(encoder.init(...)["params"])` gives); output is keyed by
the reference's torch parameter names, which are the port's.

  Dense kernel (in, out)            -> Linear weight (out, in)
  Conv kernel (kh, kw, in, out)     -> Conv2d weight (out, in, kh, kw)
  ConvTranspose kernel (kh, kw, in, out) -> ConvTranspose2d weight
                                       (in, out, kh, kw), flipped in space
  LayerNorm scale / bias            -> weight / bias
  frozen BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  ViT blocks stacked on a leading depth axis -> blocks.N, q/k/v fused into qkv

Every mapping is linear (transposes, reshapes, concatenation), so
`state_dict_from_jax` serves as well for a tree of gradients or of Adam
moments as for the weights. `lpips_state_dict_from_jax` does the same for
the Flax LPIPS tree (`pixelsplat_tpu/evaluation/lpips.py`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..evaluation.lpips import SLICE_OF, TAPS, TV_INDICES
from ..model.encoder.backbone.dino import VIT_SPECS, BackboneDinoCfg
from ..model.encoder.backbone.resnet import RESNET_SPECS
from ..model.encoder.encoder_epipolar import EncoderEpipolar, EncoderEpipolarCfg, EpipolarTransformerCfg


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose(sd: dict, prefix: str, p: Mapping) -> None:
    # Flax's ConvTranspose is a fractionally strided correlation: torch's
    # transposed convolution with the kernel flipped in space.
    kernel = np.asarray(p["kernel"])[::-1, ::-1]
    sd[f"{prefix}.weight"] = _t(kernel.transpose(2, 3, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _batchnorm(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(p["mean"])
    sd[f"{prefix}.running_var"] = _t(p["var"])


def _resnet(sd: dict, prefix: str, p: Mapping, model: str, num_layers: int) -> None:
    """A trunk and its projections; the norms only where they have
    parameters (the frozen BatchNorm of `dino_resnet50`)."""
    block_kind, stage_sizes = RESNET_SPECS[model]
    convs = (1, 2) if block_kind == "basic" else (1, 2, 3)

    def norm(name, tree, key):
        if key in tree:
            _batchnorm(sd, name, tree[key])

    _conv(sd, f"{prefix}.model.conv1", p["conv1"])
    norm(f"{prefix}.model.bn1", p, "bn1")
    _conv(sd, f"{prefix}.projections.layer0", p["projection0"])
    for stage in range(1, num_layers):
        for i in range(stage_sizes[stage - 1]):
            blk = p[f"layer{stage}_block{i}"]
            tp = f"{prefix}.model.layer{stage}.{i}"
            for n in convs:
                _conv(sd, f"{tp}.conv{n}", blk[f"conv{n}"])
                norm(f"{tp}.bn{n}", blk, f"bn{n}")
            if "downsample" in blk:
                _conv(sd, f"{tp}.downsample.0", blk["downsample"])
                norm(f"{tp}.downsample.1", blk, "bn_ds")
        _conv(sd, f"{prefix}.projections.layer{stage}", p[f"projection{stage}"])


def _dino_vit(sd: dict, prefix: str, p: Mapping, depth: int, dim: int) -> None:
    _conv(sd, f"{prefix}.patch_embed.proj", p["patch_embed"])
    sd[f"{prefix}.cls_token"] = _t(p["cls_token"])
    sd[f"{prefix}.pos_embed"] = _t(p["pos_embed"])
    _layernorm(sd, f"{prefix}.norm", p["norm"])
    blocks = p["blocks"]
    for i in range(depth):
        def at(tree):  # block i of the depth-stacked tree
            return {k: at(v) if isinstance(v, Mapping) else np.asarray(v)[i] for k, v in tree.items()}

        b = at(blocks)
        bp = f"{prefix}.blocks.{i}"
        _layernorm(sd, f"{bp}.norm1", b["norm1"])
        attn = b["attn"]
        sd[f"{bp}.attn.qkv.weight"] = _t(
            np.concatenate([attn[n]["kernel"].reshape(dim, dim).T for n in ("query", "key", "value")])
        )
        sd[f"{bp}.attn.qkv.bias"] = _t(
            np.concatenate([attn[n]["bias"].reshape(dim) for n in ("query", "key", "value")])
        )
        sd[f"{bp}.attn.proj.weight"] = _t(attn["out"]["kernel"].reshape(dim, dim).T)
        sd[f"{bp}.attn.proj.bias"] = _t(attn["out"]["bias"])
        _layernorm(sd, f"{bp}.norm2", b["norm2"])
        _linear(sd, f"{bp}.mlp.fc1", b["mlp_fc1"])
        _linear(sd, f"{bp}.mlp.fc2", b["mlp_fc2"])


def _feed_forward(sd: dict, prefix: str, p: Mapping) -> None:
    _linear(sd, f"{prefix}.net.0", p["fc1"])
    _linear(sd, f"{prefix}.net.3", p["fc2"])


def _transformer(sd: dict, prefix: str, p: Mapping, depth: int, feed_forward=_feed_forward) -> None:
    """layers.N.0 = PreNorm(Attention), layers.N.1 = PreNorm(feed-forward)."""
    for i in range(depth):
        _layernorm(sd, f"{prefix}.layers.{i}.0.norm", p[f"attn_norm_{i}"])
        for name, dense in p[f"attn_{i}"].items():  # to_qkv, or to_q and to_kv; to_out
            _linear(sd, f"{prefix}.layers.{i}.0.fn.{name}" + (".0" if name == "to_out" else ""), dense)
        _layernorm(sd, f"{prefix}.layers.{i}.1.norm", p[f"ff_norm_{i}"])
        feed_forward(sd, f"{prefix}.layers.{i}.1.fn", p[f"ff_{i}"])


def _epipolar_transformer(sd: dict, prefix: str, p: Mapping, cfg: EpipolarTransformerCfg) -> None:
    def image_self_attention_ff(sd, fn_prefix, ff):
        sa, sp = ff["self_attention"], f"{fn_prefix}.self_attention"
        _conv(sd, f"{sp}.patch_embedder.0", sa["patch_embedder"])
        _linear(sd, f"{sp}.positional_encoding.1", sa["pe_proj"])
        _transformer(sd, f"{sp}.transformer", sa["transformer"], cfg.self_attention.num_layers)
        _conv_transpose(sd, f"{sp}.resampler", sa["resampler"])

    _transformer(sd, f"{prefix}.transformer", p["transformer"], cfg.num_layers, image_self_attention_ff)
    if cfg.num_octaves > 0:
        _linear(sd, f"{prefix}.depth_encoding.1", p["depth_proj"])
    if cfg.downscale:
        _conv(sd, f"{prefix}.downscaler", p["downscaler"])
        _conv_transpose(sd, f"{prefix}.upscaler", p["upscaler"])
        _conv(sd, f"{prefix}.upscale_refinement.0", p["refine1"])
        _conv(sd, f"{prefix}.upscale_refinement.2", p["refine2"])
    if "view_embeddings" in p:
        sd[f"{prefix}.view_embeddings.weight"] = _t(p["view_embeddings"]["embedding"])


def state_dict_from_jax(params: Mapping, cfg: EncoderEpipolarCfg) -> dict[str, torch.Tensor]:
    """The port encoder's state_dict from the JAX encoder's parameter tree."""
    sd: dict[str, torch.Tensor] = {}
    bb = params["backbone"]
    if isinstance(cfg.backbone, BackboneDinoCfg):
        spec = VIT_SPECS[cfg.backbone.model]
        _dino_vit(sd, "backbone.dino", bb["dino"], spec["depth"], spec["dim"])
        _resnet(sd, "backbone.resnet_backbone", bb["resnet_backbone"], "dino_resnet50", 4)
        for mlp in ("global_token", "local_token"):
            _linear(sd, f"backbone.{mlp}_mlp.0", bb[f"{mlp}_fc1"])
            _linear(sd, f"backbone.{mlp}_mlp.2", bb[f"{mlp}_fc2"])
    else:
        _resnet(sd, "backbone", bb, cfg.backbone.model, cfg.backbone.num_layers)
    _linear(sd, "backbone_projection.1", params["backbone_projection"])
    _conv(sd, "high_resolution_skip.0", params["high_resolution_skip"])
    _linear(sd, "to_gaussians.1", params["to_gaussians"])
    _linear(sd, "depth_predictor.projection.1", params["depth_predictor"]["projection"])
    if cfg.use_epipolar_transformer:
        _epipolar_transformer(sd, "epipolar_transformer", params["epipolar_transformer"], cfg.epipolar_transformer)
    if cfg.predict_opacity:
        _linear(sd, "to_opacity.1", params["to_opacity"])
    return sd


def load_from_jax(encoder: EncoderEpipolar, params: Mapping) -> EncoderEpipolar:
    """Load the JAX encoder's parameters into `encoder` (strict)."""
    sd = state_dict_from_jax(params, encoder.cfg)
    device = next(encoder.parameters()).device
    encoder.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True)
    return encoder


def lpips_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The port LPIPS module's state_dict from the Flax LPIPS parameters
    (`{"vgg": {"conv0": ...}, "lin0": ...}`, with or without the outer
    `"params"` level)."""
    params = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    for i, tv_idx in enumerate(TV_INDICES):
        _conv(sd, f"net.slice{SLICE_OF[i]}.{tv_idx}", params["vgg"][f"conv{i}"])
    for i in range(len(TAPS)):
        _conv(sd, f"lins.{i}.model.1", params[f"lin{i}"])
    return sd
