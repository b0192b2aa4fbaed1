"""The MVSplat encoder as plain PyTorch: context views -> one 3D Gaussian a
pixel, its depth from a plane-sweep cost volume.

Written from MVSplat's description (Chen et al., "MVSplat: Efficient 3D
Gaussian Splatting from Sparse Multi-View Images", ECCV 2024,
arXiv:2403.14627; github.com/donydchen/mvsplat, `config/experiment/
re10k.yaml` over `config/model/encoder/costvolume.yaml`), view by view and
window by window, in float32 with TF32 off:

1. UniMatch's CNN on ImageNet-normalized images: a 7x7 stride-2 convolution
   to 64 channels, two residual blocks at each of 64, 96 (the first of
   stride 2) and 128 channels with instance norms (a 1x1 convolution and an
   instance norm on the shortcut where the shape changes), a 1x1
   convolution to `d_feature`: features at 1/4 resolution.
2. The multi-view transformer: a sine position encoding of each attention
   window's own grid (DETR's, normalized to 2 pi, y then x) added to every
   window; 6 blocks of one-head self-attention and cross-view attention
   (bias-free q, k, v and merge, LayerNorm after merge), the cross-view
   layer with a feed-forward on `cat[x, message]` (2d -> 8d -> d, GELU,
   bias-free) and a LayerNorm; attention inside the 2x2 windows, on odd
   blocks rolled by half a window with -100 added between pixels of
   different regions of the rolled image (Swin's mask). A view's
   cross-view keys are the same window of every other view, as they came
   into the block.
3. The cost volume: for each candidate disparity (evenly spaced from
   1 / far to 1 / near), each pixel of the feature grid (integer
   coordinates) lifted at its depth through the view's intrinsics scaled to
   the feature grid, carried to the other view by the two cameras'
   homogeneous transforms, projected by the same intrinsics, its depth
   clamped at 1e-3, and the other view's features gathered there
   bilinearly (corners aligned, zeros outside); the correlation
   sum_c f_i * f_j / sqrt(c), averaged over the other views, then the
   features beside it.
4. Refinement: a 3x3 convolution to 128 channels, GroupNorm(8), GELU, the
   U-Net, a 3x3 convolution back to the candidates, plus a 1x1 convolution
   of the volume; a 3x3 GELU 3x3 head; the softmax over the candidates;
   the coarse disparity its expectation, upsampled bilinearly (corners
   aligned), its maximum upsampled to the nearest.
5. Full resolution: the transformer's and the CNN's features through a 3x3
   convolution, upsampled bilinearly x4 (corners aligned) and GELU, a 3x3
   convolution to 32 channels, the image, the disparity and the maximum
   into a 3x3 convolution, GroupNorm(4), GELU and the U-Net; a head of two
   3x3 convolutions with a GELU gives a disparity delta and a density;
   depth = 1 / clamp(disparity + delta, 1 / far, 1 / near), opacity =
   sigmoid(density).
6. The Gaussian head: 3x3 convolution, GELU, 3x3 convolution on the
   refined features, the image and the upsampled features, to 2 xy
   offsets and pixelSplat's adapter inputs; pixelSplat's Gaussian adapter.

The U-Net is the latent-diffusion `UNetModel` without its timestep
embedding: an input 3x3 convolution; each level one residual block
(GroupNorm, SiLU, 3x3 convolution, twice; a 1x1 shortcut where the width
changes), attention where the level's stride is listed, a stride-2 3x3
convolution down but at the last level; a middle of residual block,
attention, residual block; going up, each level two residual blocks on the
features concatenated with the skip taken at the same place going down,
attention where listed, a nearest x2 upsampling and a 3x3 convolution but
at the top; GroupNorm, SiLU and a 3x3 convolution out. Its attention takes
every view's tokens of a scene together (its GroupNorm too), in heads of
32 channels, each head's q, k and v contiguous in the 1x1 projection's
output.

Departures, and details the description does not fix (the configuration's
`assumed`): the U-Net's block order above and its output block, whose
`postnorm` option could not be checked; its GroupNorms have 32 groups, or
one a channel below 32 channels (the published widths all reach 32); the
cross-view keys are the other views' block inputs (UniMatch's); the warp
projects with the reference view's intrinsics on both sides (MVSplat's);
weights are random from the seed. Parameters carry MVSplat's module names,
so one state dict loads here and into the program under test. It imports
nothing of the program under test, and runs on meta tensors for the FLOP
count.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import geometry as geo
from .encoder import quaternion_matrix, sh_rotation

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
TRANSFORMER_BLOCKS = 6
SHIFT_MASK = -100.0
MIN_PROJECTED_DEPTH = 1e-3


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(-2, -1), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    n, c = x.shape[:2]
    g = x.reshape(n, norm.num_groups, -1)
    mean = g.mean(-1, keepdim=True)
    var = ((g - mean) ** 2).mean(-1, keepdim=True)
    g = ((g - mean) / torch.sqrt(var + norm.eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return g * norm.weight.reshape(shape) + norm.bias.reshape(shape)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + norm.eps) * norm.weight + norm.bias


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    return torch.softmax(scores, dim=-1) @ v


# --------------------------------------------------------------------------
# 1. The CNN


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride))

    def forward(self, x):
        y = torch.relu(instance_norm(self.conv1(x)))
        y = torch.relu(instance_norm(self.conv2(y)))
        shortcut = instance_norm(self.downsample[0](x)) if hasattr(self, "downsample") else x
        return torch.relu(shortcut + y)


class CNN(nn.Module):
    def __init__(self, d_out: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, 1), ResidualBlock(64, 64, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2), ResidualBlock(96, 96, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, 1), ResidualBlock(128, 128, 1))
        self.conv2 = nn.Conv2d(128, d_out, 1)

    def forward(self, image):  # (3, h, w) in [0, 1] -> (d_out, h / 4, w / 4)
        mean = torch.tensor(IMAGE_MEAN, device=image.device, dtype=image.dtype).reshape(3, 1, 1)
        std = torch.tensor(IMAGE_STD, device=image.device, dtype=image.dtype).reshape(3, 1, 1)
        x = ((image - mean) / std)[None]
        x = torch.relu(instance_norm(self.conv1(x)))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x)
        return self.conv2(x)[0]


# --------------------------------------------------------------------------
# 2. The multi-view transformer


def sine_encoding(h: int, w: int, channels: int, device, dtype) -> torch.Tensor:
    """(h, w, channels): the first half encodes the row, the second the
    column, each channel pair 2i, 2i + 1 as sin, cos of position / 10000 ^
    (2i / half), positions 1..n scaled to (0, 2 pi]."""
    half = channels // 2
    out = torch.zeros((h, w, channels), device=device, dtype=dtype)
    rows = torch.arange(1, h + 1, device=device, dtype=dtype) / (h + 1e-6) * 2 * math.pi
    cols = torch.arange(1, w + 1, device=device, dtype=dtype) / (w + 1e-6) * 2 * math.pi
    for i in range(0, half, 2):
        freq = 10000.0 ** (i / half)
        out[:, :, i] = torch.sin(rows / freq)[:, None]
        out[:, :, i + 1] = torch.cos(rows / freq)[:, None]
        out[:, :, half + i] = torch.sin(cols / freq)[None, :]
        out[:, :, half + i + 1] = torch.cos(cols / freq)[None, :]
    return out


def region_labels(h: int, w: int, window: tuple, device) -> torch.Tensor:
    """(h, w) labels of the rolled image's regions: rows and columns each cut
    at size - window and size - window / 2."""
    wh, ww = window

    def cut(n, size, device):
        i = torch.arange(n, device=device)
        return (i >= n - size).long() + (i >= n - size // 2).long()

    return cut(h, wh, device)[:, None] * 3 + cut(w, ww, device)[None, :]


class AttentionLayer(nn.Module):
    def __init__(self, d: int, ffn: bool):
        super().__init__()
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.merge = nn.Linear(d, d, bias=False)
        self.norm1 = nn.LayerNorm(d)
        if ffn:
            self.mlp = nn.Sequential(nn.Linear(2 * d, 8 * d, bias=False), nn.GELU(), nn.Linear(8 * d, d, bias=False))
            self.norm2 = nn.LayerNorm(d)

    def forward(self, x, sources, splits: int, shift: bool):
        """x (h, w, c) attends, window by window, to the windows at the same
        place of each map in `sources` (a list of (h, w, c))."""
        h, w, c = x.shape
        wh, ww = h // splits, w // splits
        q, keys, values = self.q_proj(x), [self.k_proj(s) for s in sources], [self.v_proj(s) for s in sources]
        if shift:
            roll = (-(wh // 2), -(ww // 2))
            q = torch.roll(q, roll, (0, 1))
            keys = [torch.roll(k, roll, (0, 1)) for k in keys]
            values = [torch.roll(v, roll, (0, 1)) for v in values]
            labels = region_labels(h, w, (wh, ww), x.device)
        message = torch.zeros_like(q)
        for i in range(splits):
            for j in range(splits):
                rows, cols = slice(i * wh, (i + 1) * wh), slice(j * ww, (j + 1) * ww)
                qw = q[rows, cols].reshape(-1, c)
                kw = torch.cat([k[rows, cols].reshape(-1, c) for k in keys])
                vw = torch.cat([v[rows, cols].reshape(-1, c) for v in values])
                bias = None
                if shift:
                    lab = labels[rows, cols].reshape(-1)
                    same = lab[:, None] == lab[None, :]
                    bias = torch.where(same, 0.0, SHIFT_MASK).repeat(1, len(sources))
                message[rows, cols] = attend(qw, kw, vw, bias).reshape(wh, ww, c)
        if shift:
            message = torch.roll(message, (wh // 2, ww // 2), (0, 1))
        message = layer_norm(self.merge(message), self.norm1)
        if hasattr(self, "mlp"):
            hidden = gelu(self.mlp[0](torch.cat([x, message], dim=-1)))
            message = layer_norm(self.mlp[2](hidden), self.norm2)
        return x + message


class Block(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.self_attn = AttentionLayer(d, ffn=False)
        self.cross_attn_ffn = AttentionLayer(d, ffn=True)


class Transformer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.layers = nn.ModuleList([Block(d) for _ in range(TRANSFORMER_BLOCKS)])

    def forward(self, views: list, splits: int) -> list:
        """A list of (h, w, c) maps, one a view."""
        h, w, c = views[0].shape
        pos = sine_encoding(h // splits, w // splits, c, views[0].device, views[0].dtype).repeat(splits, splits, 1)
        views = [x + pos for x in views]
        for i, block in enumerate(self.layers):
            shift = splits > 1 and i % 2 == 1
            inputs = views
            out = []
            for n, x in enumerate(inputs):
                x = block.self_attn(x, [x], splits, shift)
                others = [y for m, y in enumerate(inputs) if m != n]
                out.append(block.cross_attn_ffn(x, others, splits, shift))
            views = out
        return views


class Backbone(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.backbone = CNN(d)
        self.transformer = Transformer(d)


# --------------------------------------------------------------------------
# The U-Net


def norm_layer(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, c), c)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.in_layers = nn.Sequential(norm_layer(cin), nn.SiLU(), nn.Conv2d(cin, cout, 3, 1, 1))
        self.out_layers = nn.Sequential(norm_layer(cout), nn.SiLU(), nn.Identity(), nn.Conv2d(cout, cout, 3, 1, 1))
        if cin != cout:
            self.skip_connection = nn.Conv2d(cin, cout, 1)

    def forward(self, x, views: int):
        h = self.in_layers[2](F.silu(group_norm(x, self.in_layers[0])))
        h = self.out_layers[3](F.silu(group_norm(h, self.out_layers[0])))
        return (self.skip_connection(x) if hasattr(self, "skip_connection") else x) + h


class CrossViewAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = norm_layer(c)
        self.qkv = nn.Conv1d(c, 3 * c, 1)
        self.proj_out = nn.Conv1d(c, c, 1)

    def forward(self, x, views: int):
        """x: (v b, c, h, w); every scene's tokens of all views together."""
        vb, c, h, w = x.shape
        b = vb // views
        heads = max(1, c // 32)
        d = c // heads
        out = torch.empty_like(x)
        for s in range(b):
            members = [m * b + s for m in range(views)]
            tokens = torch.cat([x[m].reshape(c, h * w) for m in members], dim=1)  # (c, v h w)
            qkv = self.qkv(group_norm(tokens[None], self.norm))[0]  # (3c, n)
            result = []
            for head in range(heads):
                part = qkv[3 * d * head:3 * d * (head + 1)]
                q, k, v = part[:d].T, part[d:2 * d].T, part[2 * d:].T
                result.append(attend(q, k, v).T)
            mixed = self.proj_out(torch.cat(result)[None])[0]
            for n, m in enumerate(members):
                out[m] = x[m] + mixed[:, n * h * w:(n + 1) * h * w].reshape(c, h, w)
        return out


class Down(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.op = nn.Conv2d(c, c, 3, 2, 1)

    def forward(self, x, views: int):
        return self.op(x)


class Up(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 1, 1)

    def forward(self, x, views: int):
        return self.conv(x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1))


class UNet(nn.Module):
    def __init__(self, c: int, mult: list, attention_res: list, views: int):
        super().__init__()
        self.views = views
        self.input_blocks = nn.ModuleList([nn.ModuleList([nn.Conv2d(c, c, 3, 1, 1)])])
        widths, ch, stride = [c], c, 1
        for level, m in enumerate(mult):
            block = [ResBlock(ch, m * c)]
            ch = m * c
            if stride in attention_res:
                block.append(CrossViewAttention(ch))
            self.input_blocks.append(nn.ModuleList(block))
            widths.append(ch)
            if level < len(mult) - 1:
                self.input_blocks.append(nn.ModuleList([Down(ch)]))
                widths.append(ch)
                stride *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch), CrossViewAttention(ch), ResBlock(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level in reversed(range(len(mult))):
            for i in range(2):
                block = [ResBlock(ch + widths.pop(), mult[level] * c)]
                ch = mult[level] * c
                if stride in attention_res:
                    block.append(CrossViewAttention(ch))
                if level > 0 and i == 1:
                    block.append(Up(ch))
                    stride //= 2
                self.output_blocks.append(nn.ModuleList(block))
        self.out = nn.Sequential(norm_layer(ch), nn.SiLU(), nn.Conv2d(ch, c, 3, 1, 1))

    def forward(self, x):
        skips = []
        for i, block in enumerate(self.input_blocks):
            for layer in block:
                x = layer(x) if i == 0 else layer(x, self.views)
            skips.append(x)
        for layer in self.middle_block:
            x = layer(x, self.views)
        for block in self.output_blocks:
            x = torch.cat([x, skips.pop()], dim=1)
            for layer in block:
                x = layer(x, self.views)
        return self.out[2](F.silu(group_norm(x, self.out[0])))


# --------------------------------------------------------------------------
# 3-6. Depth predictor and Gaussian head


class DepthPredictor(nn.Module):
    def __init__(self, cfg: dict, raw_channels: int):
        super().__init__()
        c, d, views = cfg["d_feature"], cfg["num_depth_candidates"], cfg["num_context_views"]
        cw, dw = cfg["costvolume_unet_feat_dim"], cfg["depth_unet_feat_dim"]
        self.corr_refine_net = nn.Sequential(
            nn.Conv2d(d + c, cw, 3, 1, 1), nn.GroupNorm(8, cw), nn.GELU(),
            UNet(cw, cfg["costvolume_unet_channel_mult"], cfg["costvolume_unet_attn_res"], views),
            nn.Conv2d(cw, d, 3, 1, 1),
        )
        self.regressor_residual = nn.Conv2d(d + c, d, 1)
        self.depth_head_lowres = nn.Sequential(nn.Conv2d(d, 2 * d, 3, 1, 1), nn.GELU(), nn.Conv2d(2 * d, d, 3, 1, 1))
        self.upsampler = nn.Sequential(nn.Conv2d(2 * c, c, 3, 1, 1))
        self.proj_feature = nn.Conv2d(c, dw, 3, 1, 1)
        self.refine_unet = nn.Sequential(
            nn.Conv2d(dw + 5, dw, 3, 1, 1), nn.GroupNorm(4, dw), nn.GELU(),
            UNet(dw, cfg["depth_unet_channel_mult"], cfg["depth_unet_attn_res"], views),
        )
        gpp = cfg["gaussians_per_pixel"]
        self.to_disparity = nn.Sequential(nn.Conv2d(dw, 2 * dw, 3, 1, 1), nn.GELU(), nn.Conv2d(2 * dw, 2 * gpp, 3, 1, 1))
        self.to_gaussians = nn.Sequential(
            nn.Conv2d(dw + 3 + c, 2 * raw_channels, 3, 1, 1), nn.GELU(), nn.Conv2d(2 * raw_channels, raw_channels, 3, 1, 1)
        )


def sample_bilinear(features: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """features (c, h, w) at pixel coordinates x, y (h, w) of the sample
    grid (pixel centres at integers), zero outside."""
    c, h, w = features.shape
    grid = torch.stack([2 * x / (w - 1) - 1, 2 * y / (h - 1) - 1], dim=-1)[None]
    return F.grid_sample(features[None], grid, mode="bilinear", padding_mode="zeros", align_corners=True)[0]


class Encoder(nn.Module):
    """MVSplat's encoder for a configuration's `encoder` section."""

    def __init__(self, cfg: dict):
        super().__init__()
        # Full float32: matrix products and convolutions off TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.sh_degree = cfg["gaussian_adapter"]["sh_degree"]
        self.d_sh = (self.sh_degree + 1) ** 2
        self.backbone = Backbone(cfg["d_feature"])
        self.depth_predictor = DepthPredictor(cfg, cfg["num_surfaces"] * (9 + 3 * self.d_sh))

    def cost_volume(self, feats: list, extr, intr, near, far):
        """feats: one (c, h, w) map a view of one scene; extr, intr, near,
        far of its views. Returns a list of (D + c, h, w) and the
        candidates (D,) of each view."""
        v = len(feats)
        c, h, w = feats[0].shape
        count = self.cfg["num_depth_candidates"]
        device, dtype = feats[0].device, feats[0].dtype
        ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=dtype),
                                torch.arange(w, device=device, dtype=dtype), indexing="ij")
        pixels = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (h, w, 3)
        volumes, candidates = [], []
        for i in range(v):
            k = intr[i].clone()
            k[0] = k[0] * w
            k[1] = k[1] * h
            rays = pixels @ geo.inverse_intrinsics(k).T  # (h, w, 3), depth 1
            lo, hi = 1.0 / far[i], 1.0 / near[i]
            disp = torch.stack([lo + (hi - lo) * n / (count - 1) for n in range(count)])
            total = torch.zeros((count, h, w), device=device, dtype=dtype)
            for j in [(i + s) % v for s in range(1, v)]:
                to_j = geo.inverse_se3(extr[j]) @ extr[i]
                layers = []
                for n in range(count):
                    points = geo.homogenize_points(rays / disp[n]) @ to_j.T  # (h, w, 4)
                    projected = points[..., :3] @ k.T
                    z = projected[..., 2].clamp(min=MIN_PROJECTED_DEPTH)
                    warped = sample_bilinear(feats[j], projected[..., 0] / z, projected[..., 1] / z)
                    layers.append((feats[i] * warped).sum(0) / math.sqrt(c))
                total = total + torch.stack(layers)
            volumes.append(torch.cat([total / (v - 1), feats[i]]))
            candidates.append(disp)
        return volumes, candidates

    def forward(self, context: dict, step: int, u: torch.Tensor, view_order: torch.Tensor | None = None):
        """context: image (b, v, 3, h, w), extrinsics, intrinsics, near, far;
        `u` and `view_order` are not read (MVSplat samples nothing).
        Returns (means (b, g, 3), covariances (b, g, 3, 3), harmonics
        (b, g, 3, d_sh), opacities (b, g)) in (view, pixel) order."""
        cfg = self.cfg
        image, extr, intr = context["image"], context["extrinsics"], context["intrinsics"]
        near, far = context["near"], context["far"]
        b, v, _, h, w = image.shape
        gpp, scale = cfg["gaussians_per_pixel"], cfg["downscale_factor"]
        dp = self.depth_predictor
        outs = []
        for s in range(b):
            cnn = [self.backbone.backbone(image[s, i]) for i in range(v)]
            feats = self.backbone.transformer([f.permute(1, 2, 0) for f in cnn], cfg["multiview_trans_attn_split"])
            feats = [f.permute(2, 0, 1) for f in feats]
            volumes, candidates = self.cost_volume(feats, extr[s], intr[s], near[s], far[s])
            volume = torch.stack(volumes)  # (v, D + c, h', w'), the views of one scene
            refine = dp.corr_refine_net
            x = gelu(group_norm(refine[0](volume), refine[1]))
            logits = refine[4](refine[3](x)) + dp.regressor_residual(volume)
            logits = dp.depth_head_lowres[2](gelu(dp.depth_head_lowres[0](logits)))
            pdf = torch.softmax(logits, dim=1)
            coarse = (pdf * torch.stack(candidates)[:, :, None, None]).sum(1, keepdim=True)
            peak = pdf.max(dim=1, keepdim=True)[0].repeat_interleave(scale, -2).repeat_interleave(scale, -1)
            disparity = F.interpolate(coarse, scale_factor=scale, mode="bilinear", align_corners=True)

            up = dp.upsampler[0](torch.cat([torch.stack(feats), torch.stack(cnn)], dim=1))
            up = gelu(F.interpolate(up, scale_factor=scale, mode="bilinear", align_corners=True))
            x = torch.cat([image[s], dp.proj_feature(up), disparity, peak], dim=1)
            rnet = dp.refine_unet
            refined = rnet[3](gelu(group_norm(rnet[0](x), rnet[1])))
            head = dp.to_disparity[2](gelu(dp.to_disparity[0](refined)))
            delta, density = head[:, :gpp], head[:, gpp:]
            lo, hi = (1.0 / far[s])[:, None, None, None], (1.0 / near[s])[:, None, None, None]
            depth = 1.0 / torch.minimum(torch.maximum(disparity + delta, lo), hi)  # (v, gpp, h, w)
            raw = dp.to_gaussians[2](gelu(dp.to_gaussians[0](torch.cat([refined, image[s], up], dim=1))))
            outs.append(self.adapt(raw, depth, torch.sigmoid(density), extr[s], intr[s], step))
        return tuple(torch.stack(parts) for parts in zip(*outs))

    def adapt(self, raw, depth, density, extr, intr, step):
        """pixelSplat's Gaussian adapter on one scene: raw (v, 2 + 7 + 3
        d_sh, h, w), depth and density (v, gpp, h, w)."""
        cfg, ga = self.cfg, self.cfg["gaussian_adapter"]
        v, _, h, w = raw.shape
        gpp = depth.shape[1]
        raw = raw.permute(0, 2, 3, 1).reshape(v, h * w, 1, -1)  # (v, r, 1 sample, channels)
        depth = depth.permute(0, 2, 3, 1).reshape(v, h * w, gpp)
        density = density.permute(0, 2, 3, 1).reshape(v, h * w, gpp)
        pixel = torch.tensor([1.0 / w, 1.0 / h], device=raw.device, dtype=raw.dtype)
        xy = geo.image_grid(h, w, raw.device, raw.dtype).reshape(1, h * w, 1, 2) + (torch.sigmoid(raw[..., :2]) - 0.5) * pixel
        e, k = extr[:, None, None], intr[:, None, None]
        scale = ga["gaussian_scale_min"] + (ga["gaussian_scale_max"] - ga["gaussian_scale_min"]) * torch.sigmoid(
            raw[..., 2:5]
        )
        kinv = geo.inverse_intrinsics(k)[..., :2, :2]
        multiplier = 0.1 * (kinv[..., 0, 0] * pixel[0] + kinv[..., 0, 1] * pixel[1]) + 0.1 * (
            kinv[..., 1, 0] * pixel[0] + kinv[..., 1, 1] * pixel[1]
        )
        scale = scale * depth[..., None] * multiplier[..., None]  # (v, r, gpp, 3)
        rot = raw[..., 5:9]
        rot = rot / (torch.linalg.vector_norm(rot, dim=-1, keepdim=True) + 1e-8)
        m = e[..., :3, :3] @ quaternion_matrix(rot)
        cov = (m * (scale * scale)[..., None, :]) @ m.transpose(-1, -2)

        mask = torch.ones(self.d_sh, device=raw.device, dtype=raw.dtype)
        for degree in range(1, self.sh_degree + 1):
            mask[degree**2:(degree + 1) ** 2] = 0.1 * 0.25**degree
        sh = raw[..., 9:].reshape(v, h * w, 1, 3, self.d_sh) * mask
        harmonics = sh @ sh_rotation(extr[..., :3, :3], self.sh_degree)[:, None, None].transpose(-1, -2)

        origins, dirs = geo.world_rays(xy, e, k)
        means = origins + dirs * depth[..., None]

        om = cfg["opacity_mapping"]
        exponent = 2.0 ** (om["initial"] + min(step / om["warm_up"], 1.0) * (om["final"] - om["initial"]))
        opacity = 0.5 * (1.0 - (1.0 - density) ** exponent + density ** (1.0 / exponent)) / gpp
        g = v * h * w * gpp
        return (
            means.reshape(g, 3),
            cov.reshape(g, 3, 3),
            harmonics.expand(v, h * w, gpp, 3, self.d_sh).reshape(g, 3, self.d_sh),
            opacity.reshape(g),
        )


def apply_shims(batch: dict, cfg: dict) -> dict:
    """Centre-crop every view to a multiple of `shim_patch_size *
    downscale_factor`, the focal lengths rescaled; the dataset's near and
    far stay (MVSplat has no bounds shim)."""
    patch = cfg["shim_patch_size"] * cfg["downscale_factor"]
    out = {}
    for key, views in batch.items():
        *_, h, w = views["image"].shape
        hn, wn = h // patch * patch, w // patch * patch
        r0, c0 = (h - hn) // 2, (w - wn) // 2
        k = views["intrinsics"].clone()
        k[..., 0, 0] *= w / wn
        k[..., 1, 1] *= h / hn
        out[key] = {**views, "image": views["image"][..., r0:r0 + hn, c0:c0 + wn], "intrinsics": k}
    return out
