"""The work of K10 (`csrc/linear_split.cu`) in a GS-LRM scene by hand:
every linear layer of an encoder section, 98 launches at the published
widths (the patch's layer, four a block over `depth` blocks, the head), as
FLOPs a token times the context views' tokens, one per patch. The tests
hold the reference's linear layers and the program's counter
`linear_split_flops.traced`, which `gslrm_linear_roofline.eval` reads, to
it.

A token's FLOPs are 2 x (depth x (d 3d + d d + d r d + r d d) + 9 p^2 d +
d 12 p^2) for width d, MLP ratio r and patch p: 2 x (12 x 1024^2 x 24 +
576 x 1024 + 1024 x 768) = 606,732,288 at GS-LRM's widths, 1.2426e12 over
the 2,048 tokens of a 2-view 256x256 scene."""

from __future__ import annotations

IN_CHANNELS, OUT_CHANNELS = 3 + 6, 12  # RGB and the Plücker ray; the Gaussian's parameters


def flop_per_token(encoder: dict) -> int:
    d, r, p = encoder["d_model"], encoder["mlp_ratio"], encoder["patch_size"]
    block = d * 3 * d + d * d + d * r * d + r * d * d
    return 2 * (encoder["depth"] * block + IN_CHANNELS * p * p * d + d * OUT_CHANNELS * p * p)


def tokens(encoder: dict, views: int, h: int, w: int) -> int:
    p = encoder["patch_size"]
    return views * (h // p) * (w // p)
