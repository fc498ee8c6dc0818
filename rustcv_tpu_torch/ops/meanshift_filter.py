"""Mean-shift color filtering / posterization (port of
``rustcv_tpu.ops.meanshift_filter``; OpenCV ``pyrMeanShiftFiltering``
role, Comaniciu & Meer).

Every pixel carries a (position, color) state that drifts toward its
joint spatial-color mode. One iteration is a loop over the (2·sp+1)²
window offsets; each offset is ONE whole-image gather (at the per-pixel
rounded position plus the offset) gated by the color-distance test, and
the state update is then elementwise means. Per-pixel convergence freezes
a pixel's state with ``torch.where``. The float32 tensor twin adds the
same terms in the same order as the reference's device twin; it is a
gather-heavy op by nature (the windows move per pixel) and a parity op,
not a hot-path one.

Frozen spec (float64 oracle = the same vectorized formulation in NumPy):
- pyramid: ``max_level`` halvings by ``[::2, ::2]`` decimation of the
  u8 image; levels processed coarse → fine; at each finer level every
  pixel's INITIAL color is the coarser result's color at its parent
  pixel (position restarts at the pixel itself);
- window membership: ``q ∈ B((py, px), sp)`` (rounded centre, clamped
  at borders — out-of-image offsets clamp to the edge pixel) AND
  ``Σ_c (I_c(q) − c_c)² ≤ sr²``;
- update: means of member positions / colors (an empty member set
  leaves the state unchanged);
- convergence: ``(Δpy)² + (Δpx)² ≤ 0.25`` and ``Σ_c Δc_c² ≤ 1.0``
  freezes the pixel; ``max_iter`` = 5;
- output: final colors rounded half-up to u8.
"""

from __future__ import annotations

import numpy as np
import torch

from .tensors import as_tensor


def _ms_level(img_f, init_c, sp: int, sr: float, max_iter: int, xp):
    """One pyramid level of the oracle, vectorized over all pixels.
    ``img_f`` [H, W, 3] float; ``init_c`` [H, W, 3] float initial colors."""
    h, w = img_f.shape[:2]
    flat = img_f.reshape(-1, 3)
    ys, xs = xp.meshgrid(xp.arange(h), xp.arange(w), indexing="ij")
    py = ys.astype(flat.dtype)
    px = xs.astype(flat.dtype)
    c = init_c
    frozen = xp.zeros((h, w), bool)
    sr2 = sr * sr
    for _ in range(max_iter):
        cy = xp.clip(xp.floor(py + 0.5), 0, h - 1).astype(xp.int32)
        cx = xp.clip(xp.floor(px + 0.5), 0, w - 1).astype(xp.int32)
        sum_y = xp.zeros((h, w), flat.dtype)
        sum_x = xp.zeros((h, w), flat.dtype)
        sum_c = xp.zeros((h, w, 3), flat.dtype)
        cnt = xp.zeros((h, w), flat.dtype)
        for dy in range(-sp, sp + 1):
            qy = xp.clip(cy + dy, 0, h - 1)
            for dx in range(-sp, sp + 1):
                qx = xp.clip(cx + dx, 0, w - 1)
                vals = xp.take(flat, qy * w + qx, axis=0)
                d2 = ((vals - c) ** 2).sum(axis=-1)
                m = (d2 <= sr2).astype(flat.dtype)
                sum_y = sum_y + m * qy.astype(flat.dtype)
                sum_x = sum_x + m * qx.astype(flat.dtype)
                sum_c = sum_c + m[..., None] * vals
                cnt = cnt + m
        has = cnt > 0
        safe = xp.maximum(cnt, 1.0)
        ny = xp.where(has, sum_y / safe, py)
        nx = xp.where(has, sum_x / safe, px)
        nc = xp.where(has[..., None], sum_c / safe[..., None], c)
        move2 = (ny - py) ** 2 + (nx - px) ** 2
        dcol2 = ((nc - c) ** 2).sum(axis=-1)
        done = (move2 <= 0.25) & (dcol2 <= 1.0)
        py = xp.where(frozen, py, ny)
        px = xp.where(frozen, px, nx)
        c = xp.where(frozen[..., None], c, nc)
        frozen = frozen | done
    return c


def _csum3(a: torch.Tensor) -> torch.Tensor:
    return a[..., 0] + a[..., 1] + a[..., 2]


def _ms_level_t(img_f: torch.Tensor, init_c: torch.Tensor, sp: int, sr2: float,
                max_iter: int) -> torch.Tensor:
    """One pyramid level on float32 tensors: the oracle's arithmetic in
    the same accumulation order, the offset and iteration loops in
    Python with no host read."""
    h, w = img_f.shape[:2]
    dev = img_f.device
    flat = img_f.reshape(-1, 3)
    py = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w)
    px = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w)
    c = init_c
    frozen = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        cy = torch.clamp(torch.floor(py + 0.5), 0, h - 1).to(torch.int64)
        cx = torch.clamp(torch.floor(px + 0.5), 0, w - 1).to(torch.int64)
        sum_y = torch.zeros((h, w), device=dev)
        sum_x = torch.zeros((h, w), device=dev)
        sum_c = torch.zeros((h, w, 3), device=dev)
        cnt = torch.zeros((h, w), device=dev)
        for dy in range(-sp, sp + 1):
            qy = torch.clamp(cy + dy, 0, h - 1)
            qyf = qy.to(torch.float32)
            for dx in range(-sp, sp + 1):
                qx = torch.clamp(cx + dx, 0, w - 1)
                vals = flat[qy * w + qx]
                m = (_csum3((vals - c) ** 2) <= sr2).to(torch.float32)
                sum_y = sum_y + m * qyf
                sum_x = sum_x + m * qx.to(torch.float32)
                sum_c = sum_c + m[..., None] * vals
                cnt = cnt + m
        has = cnt > 0
        safe = torch.clamp(cnt, min=1.0)
        ny = torch.where(has, sum_y / safe, py)
        nx = torch.where(has, sum_x / safe, px)
        nc = torch.where(has[..., None], sum_c / safe[..., None], c)
        done = (((ny - py) ** 2 + (nx - px) ** 2 <= 0.25)
                & (_csum3((nc - c) ** 2) <= 1.0))
        py = torch.where(frozen, py, ny)
        px = torch.where(frozen, px, nx)
        c = torch.where(frozen[..., None], c, nc)
        frozen = frozen | done
    return c


def pyr_mean_shift_numpy(img: np.ndarray, sp: int = 10, sr: float = 25.0,
                         max_level: int = 1,
                         max_iter: int = 5) -> np.ndarray:
    """Oracle — float64 NumPy. u8 (H, W, 3) → posterized u8."""
    levels = [np.asarray(img)]
    for _ in range(max_level):
        levels.append(levels[-1][::2, ::2])
    out_c = None
    for lv in range(len(levels) - 1, -1, -1):
        im = levels[lv].astype(np.float64)
        if out_c is None:
            init = im.copy()
        else:  # each pixel's parent color in the coarser result
            h, w = im.shape[:2]
            init = out_c[np.minimum(np.arange(h) // 2, out_c.shape[0] - 1)][
                :, np.minimum(np.arange(w) // 2, out_c.shape[1] - 1)]
        out_c = _ms_level(im, init, sp, sr, max_iter, np)
    return np.clip(np.floor(out_c + 0.5), 0, 255).astype(np.uint8)


def pyr_mean_shift(img, sp: int = 10, sr: float = 25.0,
                   max_level: int = 1, max_iter: int = 5) -> torch.Tensor:
    """Tensor twin — float32 on the image's device (a numpy image goes to
    the card); color-gate decisions can flip on ties, so the contract is
    distributional (≥99% of pixels within ±1), not exact."""
    x = as_tensor(img)
    sr32 = np.float32(sr)
    sr2 = float(sr32 * sr32)  # the float32 square, as the reference's
    levels = [x]
    for _ in range(max_level):
        levels.append(levels[-1][::2, ::2])
    out_c = None
    for lv in range(len(levels) - 1, -1, -1):
        im = levels[lv].to(torch.float32)
        if out_c is None:
            init = im
        else:
            h, w = im.shape[:2]
            ri = torch.clamp(torch.arange(h, device=x.device) // 2, max=out_c.shape[0] - 1)
            ci = torch.clamp(torch.arange(w, device=x.device) // 2, max=out_c.shape[1] - 1)
            init = out_c[ri][:, ci]
        out_c = _ms_level_t(im, init, sp, sr2, max_iter)
    return torch.clamp(torch.floor(out_c + 0.5), 0, 255).to(torch.uint8)
