"""Port of ``rustcv_tpu.ops.stitch`` (the port's ``sift``, ``geometry``,
``warp`` and ``blend``). Panorama stitching (OpenCV ``Stitcher`` role,
feature-based).

The reference has no stitching module; OpenCV-parity addition composed
entirely from this framework's own primitives:

    SIFT (ops/sift.py) → L2 ratio matches → findHomography RANSAC
    (ops/geometry.py) → canvas warp (ops/warp — the device remap for
    tensor inputs) → feather blend.

Split: registration is sparse host math (hundreds of keypoints);
compositing — the per-pixel work — is the device remap + elementwise
blend on the tensors' device when any input is a tensor, the NumPy
oracle otherwise.

Frozen spec:
- pairwise registration: SIFT defaults, ratio 0.75 matching,
  ``find_homography`` (seeded RANSAC, thresh 3 px) mapping ADDED image →
  anchor frame; fewer than ``min_matches`` inliers → ``StitchError``;
- canvas: union of the anchor rectangle and the H-projected corners of
  each added image, rounded out to integers; a translation matrix T
  shifts everything into positive coordinates (composited homography is
  ``T @ H``);
- feather blend: per-image weight = product of linear ramps to each
  border (1 at center row/col band, → 1/(w/2) at the edge), warped with
  the image; output = Σ w·img / Σ w (f64 accumulate, round-half-up,
  zero-weight pixels stay 0).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import geometry, sift, warp


class StitchError(RuntimeError):
    """Registration failed (not enough inliers / degenerate H)."""


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _feather_weight(h: int, w: int) -> np.ndarray:
    ry = np.minimum(np.arange(h) + 1, np.arange(h)[::-1] + 1) / ((h + 1) / 2)
    rx = np.minimum(np.arange(w) + 1, np.arange(w)[::-1] + 1) / ((w + 1) / 2)
    return np.minimum(np.outer(ry, rx), 1.0)


def register_pair(anchor_gray: np.ndarray, added_gray: np.ndarray,
                  min_matches: int = 12, ratio: float = 0.75,
                  ransac_thresh: float = 3.0):
    """Homography mapping ``added`` pixels into the ``anchor`` frame →
    (H 3×3 float64, n_inliers). Raises :class:`StitchError`."""
    _, d1 = k1d1 = sift.detect_and_compute(anchor_gray)
    _, d2 = k2d2 = sift.detect_and_compute(added_gray)
    k1, k2 = k1d1[0], k2d2[0]
    m = sift.match_descriptors_l2(d2, d1, ratio=ratio)
    if len(m) < min_matches:
        raise StitchError(f"only {len(m)} tentative matches")
    hmat, mask = geometry.find_homography(
        k2[m[:, 0], :2], k1[m[:, 1], :2], ransac_thresh=ransac_thresh)
    if hmat is None or mask.sum() < min_matches:
        raise StitchError(f"only {int(mask.sum())} RANSAC inliers")
    return hmat, int(mask.sum())


def _corners(h: int, w: int, hmat: np.ndarray) -> np.ndarray:
    c = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                 np.float64)
    q = np.concatenate([c, np.ones((4, 1))], axis=1) @ hmat.T
    return q[:, :2] / q[:, 2:]


def stitch(images: Sequence[np.ndarray], grays: Sequence[np.ndarray] = None,
           min_matches: int = 12, return_offset: bool = False,
           blend: str = "feather"):
    """Stitch ≥ 2 images (u8 (H, W[, C]), same channel count) into one
    panorama anchored at the first image (numpy arrays or tensors: with a
    tensor among them the feather composite runs on its device, the
    others uploaded there). ``grays`` optionally supplies
    registration planes (defaults to channel 0). ``blend``:
    ``feather`` (default, device-capable) or ``multiband`` (host —
    Brown-Lowe gain compensation + Voronoi seams + Laplacian-pyramid
    blending from ops/blend.py, OpenCV detail-pipeline style). Returns
    numpy."""
    if len(images) < 2:
        raise ValueError("stitch needs at least 2 images")
    imgs = [_host(im) for im in images]
    if grays is None:
        grays = [im if im.ndim == 2 else im[..., 0] for im in imgs]
    grays = [_host(g) for g in grays]
    anchor_g = np.asarray(grays[0])

    # chain registration: each image against its predecessor, composed
    # into the anchor frame (consecutive overlap is the panorama norm;
    # image k need not overlap the anchor at all)
    hs: List[np.ndarray] = [np.eye(3)]
    prev_g = anchor_g
    for g in grays[1:]:
        g = np.asarray(g)
        hmat, _ = register_pair(prev_g, g, min_matches)
        hs.append(hs[-1] @ hmat)
        prev_g = g

    # canvas bounds over all projected corners
    pts = [np.array([[0, 0], [imgs[0].shape[1] - 1, 0],
                     [0, imgs[0].shape[0] - 1],
                     [imgs[0].shape[1] - 1, imgs[0].shape[0] - 1]],
                    np.float64)]
    for im, hmat in zip(imgs[1:], hs[1:]):
        pts.append(_corners(im.shape[0], im.shape[1], hmat))
    allp = np.concatenate(pts)
    x0, y0 = np.floor(allp.min(axis=0)).astype(int)
    x1, y1 = np.ceil(allp.max(axis=0)).astype(int)
    out_w, out_h = x1 - x0 + 1, y1 - y0 + 1
    t = np.array([[1, 0, -x0], [0, 1, -y0], [0, 0, 1]], np.float64)

    device = next((im.device for im in images if isinstance(im, torch.Tensor)), None)
    nch = 1 if imgs[0].ndim == 2 else imgs[0].shape[-1]
    if blend == "multiband":
        out = _composite_multiband(imgs, hs, t, out_h, out_w)
    elif device is not None:
        out = _composite_device([torch.as_tensor(im, device=device) for im in images],
                                hs, t, out_h, out_w)
    else:
        acc = np.zeros((out_h, out_w, nch))
        wacc = np.zeros((out_h, out_w))
        for im, hmat in zip(imgs, hs):
            ih, iw = im.shape[:2]
            wplane = (_feather_weight(ih, iw) * 255).astype(np.uint8)
            m = t @ hmat
            wim = warp.warp_perspective_numpy(
                im if im.ndim == 3 else im[..., None], m, (out_w, out_h))
            wwt = warp.warp_perspective_numpy(wplane, m, (out_w, out_h))
            wf = wwt.astype(np.float64) / 255.0
            acc += wf[..., None] * wim.astype(np.float64)
            wacc += wf
        out = np.floor(acc / np.maximum(wacc, 1e-9)[..., None] + 0.5)
        out = np.where(wacc[..., None] > 0, out, 0.0)
        out = np.clip(out, 0, 255).astype(np.uint8)
        out = out[..., 0] if imgs[0].ndim == 2 else out
    if return_offset:
        return out, (-x0, -y0)   # anchor image origin inside the canvas
    return out


def _composite_multiband(imgs, hs, t, out_h: int, out_w: int):
    """Host detail-pipeline composite: warp + validity masks → gain
    compensation → sequential Voronoi-seam multi-band blending."""
    from .blend import gain_compensation, multi_band_blend_numpy, \
        voronoi_seam

    warped = []
    masks = []
    for im, hmat in zip(imgs, hs):
        ih, iw = im.shape[:2]
        m = t @ hmat
        src3 = im if im.ndim == 3 else im[..., None]
        wim = warp.warp_perspective_numpy(src3, m, (out_w, out_h))
        ones = np.full((ih, iw), 255, np.uint8)
        wmask = warp.warp_perspective_numpy(ones, m,
                                            (out_w, out_h)) > 128
        warped.append(wim)
        masks.append(wmask)
    gains = gain_compensation(warped, masks)
    warped = [np.clip(np.rint(w.astype(np.float64) * g), 0,
                      255).astype(np.uint8)
              for w, g in zip(warped, gains)]
    acc = warped[0]
    acc_mask = masks[0]
    for wim, wmask in zip(warped[1:], masks[1:]):
        keep_acc, keep_new = voronoi_seam(acc_mask, wmask)
        # blend mask: 1 keeps acc; fill non-union area from whichever
        # side is valid so pyramid borders don't bleed black
        union = acc_mask | wmask
        m1 = np.where(keep_acc, 1.0, 0.0)
        a_src = np.where(acc_mask[..., None], acc, wim)
        b_src = np.where(wmask[..., None], wim, acc)
        blended = multi_band_blend_numpy(a_src, b_src, m1, n_bands=4)
        acc = np.where(union[..., None], blended, 0).astype(np.uint8)
        acc_mask = union
    return acc[..., 0] if imgs[0].ndim == 2 else acc


def _composite_device(imgs, hs, t, out_h: int, out_w: int):
    """Device compositing of u8 tensors on one device: per-image
    canvas→source maps are built on the host in float64 (per
    registration), uploaded as float32 into ``warp.remap``; the feather
    accumulate is float32 elementwise, divided by the device weight sum."""
    dev = imgs[0].device
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    acc = None
    wacc = None
    for a, hmat in zip(imgs, hs):
        ih, iw = a.shape[:2]
        hinv = np.linalg.inv(t @ hmat)
        den = hinv[2, 0] * xs + hinv[2, 1] * ys + hinv[2, 2]
        den = np.where(np.abs(den) < 1e-12, 1e-12, den)
        mx = ((hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]) / den)
        my = ((hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]) / den)
        mx = torch.as_tensor(mx.astype(np.float32), device=dev)
        my = torch.as_tensor(my.astype(np.float32), device=dev)
        wplane = torch.as_tensor((_feather_weight(ih, iw) * 255).astype(np.uint8), device=dev)
        wim = warp.remap(a, mx, my, "constant")
        wwt = warp.remap(wplane, mx, my, "constant").to(torch.float32)
        contrib = wwt[..., None] * wim.to(torch.float32) if a.ndim == 3 \
            else wwt * wim.to(torch.float32)
        acc = contrib if acc is None else acc + contrib
        wacc = wwt if wacc is None else wacc + wwt
    wsafe = torch.clamp(wacc, min=1e-6)
    if imgs[0].ndim == 3:
        out = torch.floor(acc / wsafe[..., None] + 0.5)
        out = torch.where(wacc[..., None] > 0, out, 0.0)
    else:
        out = torch.floor(acc / wsafe + 0.5)
        out = torch.where(wacc > 0, out, 0.0)
    return out.clamp(0, 255).to(torch.uint8).cpu().numpy()
