"""The model's weights, made from the seed on the device in a few large
calls and handed as one state dict to the program and to the reference
alike.

Encoder: fan-in-scaled normals for matrices and kernels, zero biases,
unit norm scales and BatchNorm variances, zero means, a 0.02 normal
position embedding and a zero class token (pixelSplat's random
initialization, as the program's scene scripts make it). No checkpoint is
in the repository, so they are random.
"""

from __future__ import annotations

import math

import torch

from .spec import sub_seed


def _normal_block(shapes: list, generator: torch.Generator, device) -> list:
    """One standard-normal draw for every shape, split."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    return [x.view(s) for x, s in zip(flat.split(sizes), shapes)]


def encoder_weights(template: dict, seed: int, device) -> dict:
    """A state dict with the names and shapes of `template`; the draws go
    to the names in sorted order, so any module with these names gets the
    same values."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "encoder_weights"))
    random = sorted(k for k, x in template.items() if k.endswith("pos_embed") or (x.ndim >= 2 and not k.endswith("cls_token")))
    draws = dict(zip(random, _normal_block([tuple(template[k].shape) for k in random], gen, device)))
    out = {}
    for k, x in template.items():
        if k.endswith("pos_embed"):
            out[k] = draws[k] * 0.02
        elif k in draws:
            out[k] = draws[k] / math.sqrt(math.prod(x.shape[1:]))
        elif k.endswith("running_var") or (k.endswith("weight") and x.ndim == 1):
            out[k] = torch.ones(x.shape, device=device)
        else:
            out[k] = torch.zeros(x.shape, device=device)
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    """Name -> meta tensor of every state-dict entry."""
    return {k: torch.empty(v.shape, device="meta") for k, v in module.state_dict().items()}
