"""k-means clustering (port of ``rustcv_tpu.ops.kmeans``; OpenCV
``kmeans`` role — the classic vision use: color quantization).

Lloyd's iteration on the data's device: the assignment is a distance
product (‖x‖² − 2·X@Cᵀ + ‖c‖², argmin over K) in full float32 (no TF32
on the card, :func:`.tensors.full_f32`; the reference runs it at HIGHEST
precision), the update sums each cluster's points with ``index_add_``
and counts them with ``bincount``; the iterations are a Python loop with
no host read.

Deterministic: the default init is seeded k-means++ on the host (a
subsample for large N); pass ``init_centers`` to override.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .tensors import as_tensor, full_f32


def kmeans_pp_init(data, k: int, seed: int = 7,
                   sample: int = 4096) -> np.ndarray:
    """Seeded k-means++ seeding on the host (over a subsample for large
    N) — deterministic and robust where spaced/random picks collapse. A
    tensor's subsample is gathered where it lies and fetched alone."""
    rng = np.random.default_rng(seed)
    n = len(data)
    if n > sample:
        sel = rng.choice(n, sample, replace=False)
        if isinstance(data, torch.Tensor):
            x = data[torch.as_tensor(sel, device=data.device)].cpu().numpy().astype(np.float64)
        else:
            x = np.asarray(data, np.float64)[sel]
    else:
        x = (data.cpu().numpy() if isinstance(data, torch.Tensor)
             else np.asarray(data)).astype(np.float64)
    centers = [x[rng.integers(len(x))]]
    for _ in range(1, k):
        d2 = np.min(
            ((x[:, None, :] - np.array(centers)[None]) ** 2).sum(-1), axis=1
        )
        tot = d2.sum()
        if tot <= 0:
            centers.append(x[rng.integers(len(x))])
            continue
        centers.append(x[rng.choice(len(x), p=d2 / tot)])
    return np.array(centers, np.float32)


def kmeans(data, k: int, iters: int = 10, init_centers=None):
    """[N, D] float32 → (centers [k, D] f32, labels [N] int32, inertia
    f32), tensors on the data's device (numpy data goes to the card).
    Default init: seeded k-means++ (host; a tensor fetches only its
    subsample)."""
    x = as_tensor(data)
    if init_centers is None:
        init_centers = kmeans_pp_init(x, k)
    return _kmeans_device(x, as_tensor(init_centers, x.device).to(torch.float32), iters)


def _assign(x: torch.Tensor, x2: torch.Tensor, c: torch.Tensor):
    with full_f32(x.device):
        d = x2 - 2.0 * (x @ c.T) + (c * c).sum(1)[None, :]
    return torch.argmin(d, dim=1), d


def _kmeans_device(data: torch.Tensor, c0: torch.Tensor, iters: int = 10):
    """Lloyd iterations; empty clusters keep their previous center (no
    reseeding)."""
    x = data.to(torch.float32)
    k = c0.shape[0]
    x2 = (x * x).sum(1, keepdim=True)  # [N, 1]
    c = c0
    for _ in range(iters):
        lab, _ = _assign(x, x2, c)
        sums = torch.zeros_like(c).index_add_(0, lab, x)
        counts = torch.bincount(lab, minlength=k).to(torch.float32)[:, None]
        c = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), c)
    lab, d = _assign(x, x2, c)
    inertia = torch.gather(d, 1, lab[:, None]).sum()
    return c, lab.to(torch.int32), inertia


def kmeans_quantize(bgr, k: int = 8, iters: int = 10) -> Tuple:
    """Color quantization: (H, W, 3) u8 → (quantized u8 image with ≤ k
    colors, palette [k, 3] u8 numpy). A tensor image is quantized on its
    device and gives a tensor image; numpy gives numpy (computed on the
    card, as the reference computes it on its device)."""
    a = as_tensor(bgr)
    h, w = a.shape[:2]
    flat = a.reshape(-1, 3).to(torch.float32)
    init = kmeans_pp_init(flat, k)
    centers, labels, _ = kmeans(flat, k, iters, init_centers=init)
    pal = torch.clamp(torch.round(centers), 0, 255).to(torch.uint8)
    out = pal[labels.to(torch.int64)].reshape(h, w, 3)
    pal = pal.cpu().numpy()
    return (out if isinstance(bgr, torch.Tensor) else out.cpu().numpy()), pal


def kmeans_numpy(data: np.ndarray, k: int, iters: int = 10,
                 init_centers=None):
    """Float64 oracle (same init and update rules)."""
    x = data.astype(np.float64)
    n = len(x)
    c = (
        np.asarray(init_centers, np.float64).copy()
        if init_centers is not None
        else kmeans_pp_init(x, k).astype(np.float64)
    )
    for _ in range(iters):
        d = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        lab = d.argmin(1)
        for j in range(k):
            sel = lab == j
            if sel.any():
                c[j] = x[sel].mean(0)
    d = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    lab = d.argmin(1)
    return c, lab, d[np.arange(n), lab].sum()
