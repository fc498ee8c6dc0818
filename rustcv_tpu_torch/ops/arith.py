"""Per-element arithmetic (port of ``rustcv_tpu.ops.arith``: OpenCV
``add``/``addWeighted``/``absdiff``/``bitwise_*``/``convertScaleAbs``/
``norm``/``countNonZero``/``meanStdDev``/``PSNR``/``normalize``/
``accumulateWeighted`` roles), on tensors where the caller's tensor is.

Saturating u8 rounding is round half to even (``torch.round``, as
``jnp.round`` and ``np.rint``). The integer ops equal the reference
exactly. ``add_weighted_u8`` is float32: exact for dyadic weights (k/2^n)
and within ±1 LSB of the numpy oracle otherwise, the reference's tolerance.
The reductions return 0-dim tensors on the input's device (``psnr_u8`` a
Python float); L1 sums in int64, L2 and the means in float32, whose order
of summation differs between devices (a relative tolerance).
``normalize_u8`` is float32, within ±1 LSB of the float64 spec
(``golden.normalize_u8``). The numpy oracles are the reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _sat_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def add_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating u8 add."""
    return (a.to(torch.int32) + b.to(torch.int32)).clamp(max=255).to(torch.uint8)


def subtract_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating u8 subtract (clamps at 0)."""
    return (a.to(torch.int32) - b.to(torch.int32)).clamp(min=0).to(torch.uint8)


def absdiff_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.int32) - b.to(torch.int32)).abs().to(torch.uint8)


def add_weighted_u8(a: torch.Tensor, alpha: float, b: torch.Tensor, beta: float,
                    gamma: float = 0.0) -> torch.Tensor:
    """αa + βb + γ in float32 (the weights rounded to float32), round half
    to even, saturate."""
    return _sat_u8(alpha * a.to(torch.float32) + beta * b.to(torch.float32) + gamma)


def convert_scale_abs_u8(a: torch.Tensor, alpha: float = 1.0,
                         beta: float = 0.0) -> torch.Tensor:
    """|αx + β| then saturate (OpenCV ``convertScaleAbs``)."""
    return _sat_u8((alpha * a.to(torch.float32) + beta).abs())


def bitwise_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def bitwise_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def bitwise_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a ^ b


def bitwise_not(a: torch.Tensor) -> torch.Tensor:
    return ~a


def count_non_zero(a: torch.Tensor) -> torch.Tensor:
    """int32 count (0-dim tensor on the input's device)."""
    return (a != 0).sum(dtype=torch.int32)


def norm_u8(a: torch.Tensor, kind: str = "l2") -> torch.Tensor:
    """L1 / L2 / inf norm of a u8 tensor (float32 0-dim tensor; L1 summed
    exactly in int64, L2's squares summed in float32)."""
    if kind == "l1":
        return a.to(torch.int64).sum().to(torch.float32)
    if kind == "l2":
        f = a.to(torch.float32)
        return (f * f).sum().sqrt()
    if kind == "inf":
        return a.max().to(torch.float32)
    raise ValueError(f"unknown norm {kind!r} (l1, l2, inf)")


def mean_stddev_u8(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, stddev) float32 0-dim tensors (population std, OpenCV style)."""
    f = a.to(torch.float32)
    m = f.mean()
    return m, ((f * f).mean() - m * m).clamp(min=0.0).sqrt()


def psnr_u8(a: torch.Tensor, b: torch.Tensor) -> float:
    """Peak signal-to-noise ratio (dB), inf for identical inputs."""
    d = absdiff_u8(a, b).to(torch.float32)
    mse = float((d * d).mean())
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(255.0 * 255.0 / mse))


# ---------------------------------------------------------------- oracles

def add_weighted_numpy(a, alpha, b, beta, gamma=0.0):
    # mirror the device's f32 op order exactly
    v = (np.float32(alpha) * a.astype(np.float32)
         + np.float32(beta) * b.astype(np.float32) + np.float32(gamma))
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def convert_scale_abs_numpy(a, alpha=1.0, beta=0.0):
    v = np.abs((alpha * a.astype(np.float32) + np.float32(beta)))
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def norm_numpy(a, kind="l2"):
    f = a.astype(np.float64)
    if kind == "l1":
        return float(f.sum())
    if kind == "l2":
        return float(np.sqrt((f.astype(np.float32) ** 2).sum(dtype=np.float32)))
    if kind == "inf":
        return float(f.max())
    raise ValueError(kind)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 0-dim tensor on ``like``'s device: ``scalar /
    tensor`` in PyTorch multiplies by the reciprocal, where the reference
    divides."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def normalize_u8(img: torch.Tensor, alpha: float = 0.0, beta: float = 255.0,
                 kind: str = "minmax") -> torch.Tensor:
    """u8 normalize in float32 (OpenCV ``normalize`` role; frozen spec
    ``golden.normalize_u8``, ±1 LSB at scale boundaries). ``minmax`` maps
    [min, max] → [alpha, beta]; ``inf``/``l1``/``l2`` scale so the norm
    equals ``alpha``. The scale stays a tensor: nothing is read back."""
    a = img.to(torch.float32)
    if kind == "minmax":
        lo = a.min()
        hi = a.max()
        scale = torch.where(hi == lo, 0.0, _scalar(beta - alpha, a) / (hi - lo))
        out = (a - lo) * scale + alpha
    elif kind in ("inf", "l1", "l2"):
        if kind == "inf":
            n = a.abs().max()
        elif kind == "l1":
            n = a.abs().sum()
        else:
            n = (a * a).sum().sqrt()
        out = a * torch.where(n == 0, 0.0, _scalar(alpha, a) / n)
    else:
        raise ValueError(f"unknown norm kind {kind!r}")
    return torch.floor(out + 0.5).clamp(0, 255).to(torch.uint8)


def accumulate_weighted(acc, src: torch.Tensor, alpha: float) -> torch.Tensor:
    """Running average (OpenCV ``accumulateWeighted``):
    acc' = (1−α)·acc + α·src, float32 accumulator (α and 1−α in float32),
    u8 or float src."""
    a = np.float32(alpha)
    acc = torch.as_tensor(acc, device=src.device).to(torch.float32)
    return float(np.float32(1.0) - a) * acc + float(a) * src.to(torch.float32)


def accumulate_weighted_numpy(acc, src, alpha):
    return ((1.0 - np.float32(alpha)) * acc.astype(np.float32)
            + np.float32(alpha) * src.astype(np.float32))
