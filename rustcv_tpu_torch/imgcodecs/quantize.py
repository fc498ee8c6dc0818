"""The GIF writer's colour quantizer: a frame of at most 256 colours keeps
them exactly; a frame of more goes through the port's own median cut.

The palette is built on the host from the frame's colour histogram: the
box of the most pixels is split first, across its widest channel (ranges
weighted 2:3:1 for red, green and blue, as the eye weighs them) at the
pixel-weighted median, until there are 256 boxes, each entry its box's
pixel mean; then :func:`_repair` moves entries onto the colours the cut
serves worst (the largest error is what a median cut leaves worst),
keeping unused the entries the cut leaves unused. Each distinct colour is
then mapped to its nearest entry (squared RGB distance, the lowest index
on a tie) as a torch op on the frame's device, in chunks, and each pixel
takes its colour's entry. (Pillow's own median cut is C code the port does
not have; the GIF bar it is held to is in
``tests/test_torch_multipage_formats.py``.)
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np

COLOURS = 256
_CHUNK = 1 << 14  # pixels (or colours) per distance matrix (x 256 entries)
_AXIS_WEIGHTS = np.array([2.0, 3.0, 1.0])
_REPAIR = 16


def _histogram(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(the distinct colours (K, 3) u8, their counts, each pixel's colour
    number) of an (N, 3) u8 array."""
    packed = (rgb[:, 0].astype(np.uint32) << 16) | (rgb[:, 1].astype(np.uint32) << 8) | rgb[:, 2]
    keys, inverse, counts = np.unique(packed, return_inverse=True, return_counts=True)
    colours = np.stack([(keys >> 16) & 255, (keys >> 8) & 255, keys & 255], 1).astype(np.uint8)
    return colours, counts, inverse.ravel()


def median_cut(colours: np.ndarray, counts: np.ndarray, n: int = COLOURS) -> np.ndarray:
    """A palette of at most ``n`` entries (m, 3) u8 for the histogram
    (``colours`` (K, 3) u8, ``counts`` (K,))."""
    c = colours.astype(np.float64)
    w = counts.astype(np.float64)
    heap = [(-w.sum(), 0, np.arange(len(c)))]
    done, tick = [], 1
    while heap and len(heap) + len(done) < n:
        _, _, idx = heapq.heappop(heap)
        spread = (c[idx].max(0) - c[idx].min(0)) * _AXIS_WEIGHTS
        if spread.max() == 0:
            done.append(idx)
            continue
        ch = int(np.argmax(spread))
        order = idx[np.argsort(c[idx, ch], kind="stable")]
        cum = np.cumsum(w[order])
        cut = min(max(int(np.searchsorted(cum, cum[-1] / 2)) + 1, 1), len(order) - 1)
        vals = c[order, ch]
        if vals[cut] == vals[cut - 1]:  # never split a run of one value
            lo = int(np.searchsorted(vals, vals[cut], side="left"))
            hi = int(np.searchsorted(vals, vals[cut], side="right"))
            cut = hi if lo == 0 or (hi != len(order) and hi - cut <= cut - lo) else lo
        for part in (order[:cut], order[cut:]):
            heapq.heappush(heap, (-w[part].sum(), tick, part))
            tick += 1
    boxes = done + [b for _, _, b in heap]
    pal = np.array([(c[b] * w[b][:, None]).sum(0) / w[b].sum() for b in boxes])
    return _repair(colours, counts, np.clip(np.rint(pal), 0, 255).astype(np.uint8))


def _two_nearest(c, p):
    """For colours ``c`` (K, 3) and entries ``p`` (m, 3), float64 tensors of
    whole numbers: each colour's nearest entry (squared RGB distance, the
    lowest index on a tie, as :func:`nearest` picks it), its error (the
    largest of the three channels' |diff|), the same error to the
    second-nearest entry, and how much its squared distance grows when it
    moves there."""
    import torch

    near = torch.empty(len(c), dtype=torch.long)
    err, err2, gain = (torch.empty(len(c), dtype=torch.float64) for _ in range(3))
    pp = (p * p).sum(1)
    for s in range(0, len(c), _CHUNK):
        cc = c[s:s + _CHUNK]
        d = (cc * cc).sum(1, keepdim=True) + pp - 2 * cc @ p.T  # exact: whole numbers < 2^53
        n1 = d.argmin(1, keepdim=True)
        d1 = d.gather(1, n1)
        d.scatter_(1, n1, float("inf"))
        n2 = d.argmin(1, keepdim=True)
        near[s:s + _CHUNK] = n1[:, 0]
        gain[s:s + _CHUNK] = (d.gather(1, n2) - d1)[:, 0]
        err[s:s + _CHUNK] = (cc - p[n1[:, 0]]).abs().amax(1)
        err2[s:s + _CHUNK] = (cc - p[n2[:, 0]]).abs().amax(1)
    return near, err, err2, gain


def _repair(colours: np.ndarray, counts: np.ndarray, pal: np.ndarray) -> np.ndarray:
    """Move entries onto the colours the cut serves worst. :data:`_REPAIR`
    times, the colour farthest from its nearest entry (``err``) becomes an
    entry in place of the used entry that costs least to lose (its pixels
    times how much farther their next-nearest entry is), among those whose
    colours would all stay nearer than that farthest one: the largest error
    never grows. Entries the cut leaves unused stay unused, as Pillow's cut
    leaves some (the GIF writer then has a free entry for a transparent
    index, as Pillow's has); if the cut used them all, each entry the moves
    emptied then moves onto the farthest colour until none is left (a colour
    that is an entry and equals no other is its own nearest, so each move
    adds an entry that stays used, and this ends). On the host (torch on the
    CPU)."""
    import torch

    if len(pal) < 2:
        return pal
    c = torch.from_numpy(colours.astype(np.float64))
    w = torch.from_numpy(counts.astype(np.float64))
    p = torch.from_numpy(pal.astype(np.float64))
    m = len(p)
    full, repairs = None, _REPAIR  # full: whether the cut left no entry unused
    for _ in range(_REPAIR + m):
        near, err, err2, gain = _two_nearest(c, p)
        used = torch.bincount(near, minlength=m) > 0
        if full is None:
            full = bool(used.all())
        worst = int(err.argmax())
        if err[worst] == 0:  # every colour is an entry
            break
        cost = torch.full((m,), float("inf"), dtype=torch.float64)
        if repairs:
            repairs -= 1
            loss = torch.zeros(m, dtype=torch.float64).scatter_reduce_(0, near, err2, "amax")
            ok = used & (loss < err[worst])
            ok[near[worst]] = False
            cost[ok] = torch.zeros(m, dtype=torch.float64).index_add_(0, near, gain * w)[ok]
        if torch.isinf(cost).all():  # no repair left: fill what the moves emptied
            repairs = 0
            if not full or used.all():
                break
            cost[~used] = 0
        p[int(cost.argmin())] = c[worst]
    return p.to(torch.uint8).numpy()


def nearest(pixels, palette: np.ndarray):
    """Each pixel's nearest palette entry: ``pixels`` an (N, 3) u8 tensor on
    any device, ``palette`` (m, 3) u8; squared RGB distance, the lowest
    index on a tie (``argmin``'s first). Returns (N,) u8 on that device."""
    import torch

    pal = torch.as_tensor(palette.astype(np.int32), device=pixels.device)
    out = torch.empty(pixels.shape[0], dtype=torch.uint8, device=pixels.device)
    for s in range(0, pixels.shape[0], _CHUNK):
        p = pixels[s:s + _CHUNK].to(torch.int32)
        d = ((p[:, None, :] - pal[None]) ** 2).sum(2)
        out[s:s + _CHUNK] = d.argmin(1).to(torch.uint8)
    return out


def quantize(frame) -> Tuple[np.ndarray, np.ndarray]:
    """An (H, W, 3) RGB u8 frame (numpy, or a tensor on its device) →
    (indices (H, W) u8, palette (m, 3) u8): its own colours when it has at
    most 256, else the median cut's, each distinct colour mapped on the
    frame's device and each pixel given its colour's entry."""
    import torch

    t = frame if isinstance(frame, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(frame))
    host = t.cpu().numpy()
    h, w = host.shape[:2]
    colours, counts, inverse = _histogram(host.reshape(-1, 3))
    if len(colours) <= COLOURS:
        return inverse.astype(np.uint8).reshape(h, w), colours
    palette = median_cut(colours, counts)
    idx = nearest(torch.from_numpy(colours).to(t.device), palette).cpu().numpy()[inverse]
    return idx.reshape(h, w), palette
