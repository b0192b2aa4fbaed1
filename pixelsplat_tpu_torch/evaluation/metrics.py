"""Image metrics: PSNR and SSIM.

Port of `pixelsplat_tpu/evaluation/metrics.py`:
- PSNR: -10 log10(mse) on [0,1]-clipped images.
- SSIM: skimage's structural_similarity(win_size=11, gaussian_weights=True
  (sigma 1.5, truncate 3.5), channel_axis=0, data_range=1.0,
  use_sample_covariance=True). The Gaussian window's radius equals the
  border that is cropped, so the values kept do not depend on how the
  border is padded: convolve with zero padding, then crop.
- LPIPS: `lpips.py`.

Both run in full float32 on any device: the separable filter is a cuDNN
convolution on the card, where PyTorch lets cuDNN use TF32 by default, so
SSIM turns TF32 off around it (TF32 moves SSIM by about 1e-3).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def compute_psnr(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """(b, c, h, w) images in [0,1] -> (b,) PSNR in dB."""
    gt = ground_truth.clamp(0.0, 1.0)
    hat = predicted.clamp(0.0, 1.0)
    mse = ((gt - hat) ** 2).mean(dim=(1, 2, 3))
    return -10.0 * torch.log10(mse)


@lru_cache(maxsize=4)
def _gaussian_kernel(sigma: float = 1.5, truncate: float = 3.5) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _filter2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable 2D filter over the last two axes, 'same' zero padding."""
    k = kernel.shape[0]
    pad = k // 2
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    flat = x.reshape(-1, 1, h, w)
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled, benchmark=cudnn.benchmark, benchmark_limit=cudnn.benchmark_limit,
        deterministic=cudnn.deterministic, allow_tf32=False,
    ):
        out = F.conv2d(flat, kernel.reshape(1, 1, k, 1), padding=(pad, 0))
        out = F.conv2d(out, kernel.reshape(1, 1, 1, k), padding=(0, pad))
    return out.reshape(*lead, h, w)


def compute_ssim(
    ground_truth: torch.Tensor,
    predicted: torch.Tensor,
    data_range: float = 1.0,
    sigma: float = 1.5,
    truncate: float = 3.5,
) -> torch.Tensor:
    """(b, c, h, w) -> (b,) mean SSIM (skimage-compatible)."""
    kernel = torch.from_numpy(_gaussian_kernel(sigma, truncate)).to(ground_truth)
    win_size = kernel.shape[0]
    pad = (win_size - 1) // 2
    np_points = win_size * win_size
    cov_norm = np_points / (np_points - 1)  # sample covariance

    x = ground_truth
    y = predicted
    ux = _filter2d(x, kernel)
    uy = _filter2d(y, kernel)
    uxx = _filter2d(x * x, kernel)
    uyy = _filter2d(y * y, kernel)
    uxy = _filter2d(x * y, kernel)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    s = s[..., pad:-pad, pad:-pad]
    return s.mean(dim=(1, 2, 3))
