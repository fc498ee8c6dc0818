"""SLIC superpixels (port of ``rustcv_tpu.ops.slic``; OpenCV
``ximgproc.createSuperpixelSLIC`` role).

Frozen spec (slic_numpy, float64): classic SLIC restricted to the 3×3
cell neighborhood — each pixel considers the 9 clusters whose home
cells surround its own (equivalent coverage to the paper's 2S×2S
search window), distance D² = ‖Δcolor‖² + (ruler/S)²·‖Δxy‖², centers
initialized to block means, 10 Lloyd iterations, then a host
connectivity pass that absorbs islands smaller than S²/4 into the
neighbor with the longest shared boundary.

The tensor twin (:func:`slic_device`) pads the image to whole S×S cells;
per-pixel candidate centers are the center maps rolled by the 9 offsets
and upsampled with ``repeat_interleave``, the assignment is elementwise,
and the center update sums each offset's pixels per cell (a reshape and
sum) and rolls the sums back; the iterations are a Python loop with no
host read. The connectivity pass stays on the host (pointer-chasing).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _prep(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    return a.astype(np.float64)


def _pad_to(a, s: int, xp):
    h, w = a.shape[:2]
    ph = (-h) % s
    pw = (-w) % s
    if ph or pw:
        a = xp.pad(a, ((0, ph), (0, pw), (0, 0)), mode="edge")
    return a


def slic_numpy(img: np.ndarray, region_size: int = 20, ruler: float = 10.0,
               num_iterations: int = 10) -> np.ndarray:
    """Oracle — raw labels (H, W) int32 = home-cell index of the
    assigned cluster (before connectivity enforcement)."""
    feat = _prep(img)
    h0, w0 = feat.shape[:2]
    s = int(region_size)
    feat = _pad_to(feat, s, np)
    h, w, c = feat.shape
    gh, gw = h // s, w // s
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    fxy = np.stack([ys, xs], -1)
    wxy = (ruler / s) ** 2

    # centers = block means of (feat, xy)
    def block_mean(a):
        return a.reshape(gh, s, gw, s, -1).mean(axis=(1, 3))

    cf = block_mean(feat)                      # (gh, gw, c)
    cxy = block_mean(fxy)                      # (gh, gw, 2)

    lab_off = np.zeros((h, w), np.int64)
    for _ in range(num_iterations):
        best = np.full((h, w), np.inf)
        lab_off = np.zeros((h, w), np.int64)
        for oi, (dy, dx) in enumerate(_OFFSETS):
            # candidate center of cell (home+o) per pixel, invalid → inf
            ccf = np.roll(cf, (-dy, -dx), axis=(0, 1))
            ccxy = np.roll(cxy, (-dy, -dx), axis=(0, 1))
            pcf = ccf.repeat(s, 0).repeat(s, 1)
            pcxy = ccxy.repeat(s, 0).repeat(s, 1)
            d = (((feat - pcf) ** 2).sum(-1)
                 + wxy * ((fxy - pcxy) ** 2).sum(-1))
            gy = np.arange(gh)[:, None] + dy
            gx = np.arange(gw)[None, :] + dx
            invalid = ((gy < 0) | (gy >= gh) | (gx < 0) | (gx >= gw))
            d = np.where(invalid.repeat(s, 0).repeat(s, 1), np.inf, d)
            better = d < best
            best = np.where(better, d, best)
            lab_off = np.where(better, oi, lab_off)
        # update: masked block sums rolled back
        sf = np.zeros_like(cf)
        sxy = np.zeros_like(cxy)
        cnt = np.zeros((gh, gw, 1))
        for oi, (dy, dx) in enumerate(_OFFSETS):
            m = (lab_off == oi)[..., None].astype(np.float64)
            bs_f = (feat * m).reshape(gh, s, gw, s, c).sum(axis=(1, 3))
            bs_xy = (fxy * m).reshape(gh, s, gw, s, 2).sum(axis=(1, 3))
            bs_n = m.reshape(gh, s, gw, s, 1).sum(axis=(1, 3))
            sf += np.roll(bs_f, (dy, dx), axis=(0, 1))
            sxy += np.roll(bs_xy, (dy, dx), axis=(0, 1))
            cnt += np.roll(bs_n, (dy, dx), axis=(0, 1))
        nz = cnt[..., 0] > 0
        cf = np.where(nz[..., None], sf / np.maximum(cnt, 1), cf)
        cxy = np.where(nz[..., None], sxy / np.maximum(cnt, 1), cxy)

    # final labels = home cell + chosen offset
    gy = (np.arange(h) // s)[:, None] + np.array(
        [dy for dy, _ in _OFFSETS])[lab_off].reshape(h, w)
    gx = (np.arange(w) // s)[None, :] + np.array(
        [dx for _, dx in _OFFSETS])[lab_off].reshape(h, w)
    labels = (gy * gw + gx).astype(np.int32)
    return labels[:h0, :w0]


def slic_device(img, region_size: int = 20, ruler: float = 10.0,
                num_iterations: int = 10) -> torch.Tensor:
    """Tensor twin — raw labels (H, W) int32 on the image's device (numpy
    goes to the card); the same spec in float32."""
    a = img if isinstance(img, torch.Tensor) else torch.as_tensor(np.asarray(img), device="cuda")
    if a.ndim == 2:
        a = a[..., None]
    feat = a.to(torch.float32)
    h0, w0 = feat.shape[:2]
    s = int(region_size)
    ph, pw = (-h0) % s, (-w0) % s
    if ph or pw:  # edge padding to whole cells
        feat = torch.cat([feat, feat[-1:].expand(ph, -1, -1)], 0)
        feat = torch.cat([feat, feat[:, -1:].expand(-1, pw, -1)], 1)
    h, w, c = feat.shape
    gh, gw = h // s, w // s
    dev = feat.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w)
    fxy = torch.stack([ys, xs], -1)
    wxy = float(np.float32((ruler / s) ** 2))

    def block_sum(x):
        return x.reshape(gh, s, gw, s, -1).sum(dim=(1, 3))

    def up(cells):
        return cells.repeat_interleave(s, 0).repeat_interleave(s, 1)

    area = torch.full((1,), float(s * s), device=dev)  # a true division
    cf = block_sum(feat) / area
    cxy = block_sum(fxy) / area
    gy_cell = torch.arange(gh, device=dev)[:, None]
    gx_cell = torch.arange(gw, device=dev)[None, :]
    invalid = [up(((gy_cell + dy < 0) | (gy_cell + dy >= gh)
                   | (gx_cell + dx < 0) | (gx_cell + dx >= gw)).expand(gh, gw))
               for dy, dx in _OFFSETS]

    def assign(cf, cxy):
        best = torch.full((h, w), float("inf"), device=dev)
        lab = torch.zeros((h, w), dtype=torch.int64, device=dev)
        for oi, (dy, dx) in enumerate(_OFFSETS):
            pcf = up(torch.roll(cf, (-dy, -dx), (0, 1)))
            pcxy = up(torch.roll(cxy, (-dy, -dx), (0, 1)))
            df = (feat - pcf) ** 2
            dxy = (fxy - pcxy) ** 2
            d = df.sum(-1) + wxy * (dxy[..., 0] + dxy[..., 1])
            d = torch.where(invalid[oi], float("inf"), d)
            better = d < best
            best = torch.where(better, d, best)
            lab = torch.where(better, oi, lab)
        return lab

    for _ in range(num_iterations):
        lab = assign(cf, cxy)
        sf = torch.zeros_like(cf)
        sxy = torch.zeros_like(cxy)
        cnt = torch.zeros((gh, gw, 1), device=dev)
        for oi, (dy, dx) in enumerate(_OFFSETS):
            m = (lab == oi)[..., None].to(torch.float32)
            sf = sf + torch.roll(block_sum(feat * m), (dy, dx), (0, 1))
            sxy = sxy + torch.roll(block_sum(fxy * m), (dy, dx), (0, 1))
            cnt = cnt + torch.roll(block_sum(m), (dy, dx), (0, 1))
        nz = cnt > 0
        cf = torch.where(nz, sf / torch.clamp(cnt, min=1.0), cf)
        cxy = torch.where(nz, sxy / torch.clamp(cnt, min=1.0), cxy)

    lab = assign(cf, cxy)
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)
    gy = (torch.arange(h, device=dev) // s)[:, None] + offs[lab, 0]
    gx = (torch.arange(w, device=dev) // s)[None, :] + offs[lab, 1]
    return (gy * gw + gx).to(torch.int32)[:h0, :w0]


def enforce_connectivity(labels: np.ndarray, min_size: int
                         ) -> Tuple[np.ndarray, int]:
    """Host finishing pass: split disconnected label fragments, absorb
    components < min_size into the adjacent component sharing the
    longest boundary, then compact label ids → (labels, n)."""
    h, w = labels.shape
    comp = np.full((h, w), -1, np.int64)
    sizes = []
    stack = []
    n = 0
    for y0 in range(h):
        for x0 in range(w):
            if comp[y0, x0] >= 0:
                continue
            lv = labels[y0, x0]
            stack.append((y0, x0))
            comp[y0, x0] = n
            count = 0
            while stack:
                y, x = stack.pop()
                count += 1
                for yy, xx in ((y - 1, x), (y + 1, x), (y, x - 1),
                               (y, x + 1)):
                    if (0 <= yy < h and 0 <= xx < w
                            and comp[yy, xx] < 0
                            and labels[yy, xx] == lv):
                        comp[yy, xx] = n
                        stack.append((yy, xx))
            sizes.append(count)
            n += 1
    sizes = np.asarray(sizes)
    # absorb small components into the 4-neighbor component with the
    # longest shared boundary (iterate until stable; small counts)
    for _ in range(4):
        small = np.nonzero(sizes < min_size)[0]
        if len(small) == 0:
            break
        small_set = set(int(sid) for sid in small)
        contact: dict = {}
        for y in range(h):
            for x in range(w):
                a = int(comp[y, x])
                if a not in small_set:
                    continue
                for yy, xx in ((y + 1, x), (y, x + 1), (y - 1, x),
                               (y, x - 1)):
                    if 0 <= yy < h and 0 <= xx < w:
                        b = int(comp[yy, xx])
                        if b != a:
                            contact[(a, b)] = contact.get((a, b), 0) + 1
        merged = False
        for sid in small:
            cands = [(cnt, b) for (a, b), cnt in contact.items()
                     if a == sid]
            if not cands:
                continue
            _, tgt = max(cands)
            comp[comp == sid] = tgt
            sizes[tgt] += sizes[sid]
            sizes[sid] = 0
            merged = True
        if not merged:
            break
        # recompact ids
        uniq, comp = np.unique(comp, return_inverse=True)
        comp = comp.reshape(h, w)
        new_sizes = np.bincount(comp.ravel())
        sizes = new_sizes
    uniq, comp = np.unique(comp, return_inverse=True)
    return comp.reshape(h, w).astype(np.int32), int(len(uniq))


def slic_superpixels(img, region_size: int = 20, ruler: float = 10.0,
                     num_iterations: int = 10,
                     enforce: bool = True) -> Tuple[np.ndarray, int]:
    """→ (labels (H, W) int32 compact ids, n_superpixels). A tensor takes
    the tensor twin on its device (then the host finish); anything else
    the float64 oracle."""
    if isinstance(img, torch.Tensor):
        raw = slic_device(img, region_size, ruler, num_iterations).cpu().numpy()
    else:
        raw = slic_numpy(np.asarray(img), region_size, ruler, num_iterations)
    if not enforce:
        uniq, inv = np.unique(raw, return_inverse=True)
        return inv.reshape(raw.shape).astype(np.int32), len(uniq)
    return enforce_connectivity(raw, (region_size * region_size) // 4)
