"""Image pyramid and separable Gaussian blur.

Port of `orbslam2_tpu.ops.pyramid`: successive bilinear downscales with
half-pixel centres and no antialiasing (``jax.image.resize(...,
"bilinear", antialias=False)`` is ``F.interpolate(mode="bilinear",
align_corners=False, antialias=False)``), and the 7x7 sigma=2 blur with
reflect padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from orbslam2_tpu_torch.config import OrbConfig


def level_scales(orb: OrbConfig) -> list[float]:
    """Scale of each pyramid level (1.0, 1.2, 1.44, ...)."""
    return [orb.scale_factor**i for i in range(orb.num_levels)]


def level_shapes(height: int, width: int, orb: OrbConfig) -> list[tuple[int, int]]:
    """Static (H, W) per level, rounded like cv::resize(1/scale)."""
    return [
        (max(int(round(height / s)), 32), max(int(round(width / s)), 32))
        for s in level_scales(orb)
    ]


def feature_budgets(orb: OrbConfig) -> list[int]:
    """Per-level feature budget with geometric decay 1/scale_factor:
    nfeatures * (1-f)/(1-f^L) * f^l, remainder to the coarsest level."""
    f = 1.0 / orb.scale_factor
    n = orb.num_features
    first = n * (1 - f) / (1 - f**orb.num_levels)
    budgets = [int(round(first * f**i)) for i in range(orb.num_levels - 1)]
    budgets.append(max(n - sum(budgets), 0))
    return budgets


def build_pyramid(image: torch.Tensor, orb: OrbConfig) -> list[torch.Tensor]:
    """Grayscale image [H, W] float32 -> list of per-level images, each
    resized from the previous level."""
    levels = [image]
    shapes = level_shapes(image.shape[0], image.shape[1], orb)
    for lvl in range(1, orb.num_levels):
        prev = levels[-1][None, None]
        levels.append(
            F.interpolate(prev, size=shapes[lvl], mode="bilinear",
                          align_corners=False, antialias=False)[0, 0]
        )
    return levels


def gaussian_kernel_1d(size: int = 7, sigma: float = 2.0, device=None) -> torch.Tensor:
    half = size // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def gaussian_blur(image: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable blur with reflect padding, [..., H, W] -> [..., H, W];
    `taps` is the odd-length 1-D kernel (gaussian_kernel_1d)."""
    size = taps.shape[0]
    half = size // 2
    H, W = image.shape[-2:]
    x4 = image.reshape(-1, 1, H, W)
    x = F.pad(x4, (0, 0, half, half), mode="reflect")
    rows = sum(x[:, :, i : i + H, :] * taps[i] for i in range(size))
    y = F.pad(rows, (half, half, 0, 0), mode="reflect")
    out = sum(y[:, :, :, i : i + W] * taps[i] for i in range(size))
    return out.reshape(image.shape)

