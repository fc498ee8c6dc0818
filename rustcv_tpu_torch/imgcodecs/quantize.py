"""The GIF writer's colour quantizer: Pillow's median cut (``Quant.c``'s
``quantize``, method 0 without k-means, what ``convert("P",
palette=ADAPTIVE)`` runs), the same palette in the same order and the same
index for every pixel.

* The histogram: the frame's distinct colours and their pixel counts. Where
  there are more than 65,536, every channel drops its low bit (then its two
  low bits, ...) until no more than 65,536 remain, as Quant.c rebuilds its
  colour hash coarser; the cut runs on those coarse colours.
* The cut: the boxes wait in Quant.c's binary max-heap on pixel count (its
  ties broken as that heap breaks them); a box of one colour leaves the heap
  unsplit; at most 255 splits, so at most 256 entries. A box is split across the channel
  of the widest range weighted 77:150:29 (red before green before blue on a
  tie), at the run of one value where the pixel count, summed from the high
  end, first passes half the box's: that run and everything above it make
  the first box, the rest the second (where the half falls in the lowest
  run, that run alone is the second).
* The palette: the leaves in order, the first box before the second; each
  entry the pixel-weighted mean of its box's full-precision colours, rounded
  half up.
* The mapping: each colour keeps its box's entry unless another is strictly
  nearer (squared RGB distance); of equally near ones it takes the one
  nearest its box's entry, then the lowest index, the order in which
  Quant.c searches them. A torch op on the frame's device, in chunks.

A frame of at most 256 colours goes through the same cut and keeps its own
colours, in the cut's order. The histogram and the mapping run on the
frame's device, the box bookkeeping on the host. Each rule is pinned
against Pillow in ``tests/test_torch_quantize.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

COLOURS = 256
MAX_COLOURS = 65536  # Quant.c's MAX_HASH_ENTRIES: the most colours the cut starts from
_CHUNK = 1 << 16  # colours per distance matrix (x the palette's entries)
_WEIGHTS = np.array([77, 150, 29], np.int64)  # Quant.c's weights of the channels' ranges


def _channels(keys):
    return keys >> 16, (keys >> 8) & 255, keys & 255


def coarse_histogram(keys, counts):
    """Quant.c's hash of the distinct colours: ``keys`` (K,) packed
    ``r << 16 | g << 8 | b`` and their ``counts``, tensors on any device →
    (the bits dropped per channel, the coarse colours (K', 3) int64 numpy,
    their pixel counts (K',) int64 numpy, each distinct colour's coarse
    colour (K,) on the device), with K' <= :data:`MAX_COLOURS`."""
    import torch

    scale, coarse, inverse = 0, keys, torch.arange(len(keys), device=keys.device)
    while len(coarse) > MAX_COLOURS:
        scale += 1
        r, g, b = _channels(keys)
        coarse, inverse = torch.unique(((r >> scale) << 16) | ((g >> scale) << 8) | (b >> scale),
                                       return_inverse=True)
    sums = torch.zeros(len(coarse), dtype=torch.int64, device=keys.device)
    sums.index_add_(0, inverse, counts.to(torch.int64))
    cols = torch.stack(_channels(coarse), 1).cpu().numpy().astype(np.int64)
    return scale, cols, sums.cpu().numpy(), inverse


class _Heap:
    """Quant.c's ``QuantHeap`` of boxes on their pixel count: a binary
    max-heap, 1-based, with its own sift-up and sift-down."""

    def __init__(self, key):
        self.key, self.h = key, [None]

    def add(self, v) -> None:
        h, key = self.h, self.key
        h.append(None)
        k = len(h) - 1
        while k != 1 and key[v] > key[h[k // 2]]:
            h[k] = h[k // 2]
            k //= 2
        h[k] = v

    def remove(self):
        h, key = self.h, self.key
        if len(h) == 1:
            return None
        top, v = h[1], h.pop()
        n, k = len(h) - 1, 1
        if n == 0:
            return top
        while k * 2 <= n:
            child = k * 2
            if child < n and key[h[child]] < key[h[child + 1]]:
                child += 1
            if key[v] > key[h[child]]:
                break
            h[k] = h[child]
            k = child
        h[k] = v
        return top


def median_cut(cols: np.ndarray, counts: np.ndarray) -> Tuple[np.ndarray, int]:
    """Quant.c's ``median_cut`` into at most :data:`COLOURS` boxes over a
    histogram (``cols`` (K, 3) int, ``counts`` (K,)) → (each colour's box
    (K,) int64, the number of boxes),
    the boxes numbered in the tree's order, the first half before the
    second."""
    members = [np.arange(len(cols))]  # box -> its colours
    pixels = [int(counts.sum())]  # box -> its pixel count
    kids = {}  # box -> (first, second)
    heap = _Heap(pixels)
    heap.add(0)
    for _ in range(COLOURS - 1):
        while True:
            box = heap.remove()
            if box is None:
                break
            c = cols[members[box]]
            lo, hi = c.min(0), c.max(0)
            if (hi > lo).any():  # a volume above 1
                break
        if box is None:
            break
        axis = int(np.argmax((hi - lo) * _WEIGHTS))  # the first of equal ones, as Quant.c's <
        vals = c[:, axis]
        per_value = np.bincount(vals, weights=counts[members[box]], minlength=256)
        crossed = np.cumsum(per_value[::-1]) * 2 > pixels[box]  # from the high end
        first = vals >= 255 - int(np.argmax(crossed))
        if first.all():  # the half falls in the lowest run: that run alone is the second box
            first = vals > lo[axis]
        for part in (members[box][first], members[box][~first]):
            members.append(part)
            pixels.append(int(counts[part].sum()))
            heap.add(len(members) - 1)
        kids[box] = (len(members) - 2, len(members) - 1)
    box_of = np.empty(len(cols), np.int64)
    order, stack = 0, [0]
    while stack:  # the leaves, depth first, the first half before the second
        box = stack.pop()
        if box in kids:
            stack.extend(kids[box][::-1])
        else:
            box_of[members[box]] = order
            order += 1
    return box_of, order


def palette_of(colours, counts, box, m: int) -> np.ndarray:
    """Quant.c's ``compute_palette_from_median_cut``: each box's
    pixel-weighted mean of its colours (tensors on any device: the distinct
    colours (K, 3) int64, their counts, their box), rounded half up; the
    sums in 32 bits, as Quant.c keeps them. → (m, 3) u8."""
    import torch

    sums = torch.zeros((m, 3), dtype=torch.int64, device=colours.device)
    sums.index_add_(0, box, colours * counts[:, None])
    n = torch.zeros(m, dtype=torch.int64, device=colours.device).index_add_(0, box, counts)
    sums, n = sums.cpu().numpy() % (1 << 32), n.cpu().numpy() % (1 << 32)
    return np.floor(0.5 + sums / n[:, None]).astype(np.uint8)


def nearest(colours, box, palette: np.ndarray):
    """Quant.c's ``map_image_pixels_from_median_box``: for each colour
    (``colours`` (K, 3), a tensor on any device) and its ``box`` (K,), its
    box's entry unless another is strictly nearer; of equally near entries
    the one nearest the box's entry, then the lowest index. Returns (K,)
    int64 on that device."""
    import torch

    dev = colours.device
    pal = torch.as_tensor(palette, dtype=torch.float64, device=dev)
    m = len(pal)
    pp = (pal * pal).sum(1)
    # the entries in Quant.c's search order from each box's entry: by distance, then index
    rank = (pp[:, None] + pp - 2 * pal @ pal.T) * m + torch.arange(m, device=dev)
    out = torch.empty(len(colours), dtype=torch.int64, device=dev)
    for s in range(0, len(colours), _CHUNK):
        c, b = colours[s:s + _CHUNK].to(torch.float64), box[s:s + _CHUNK]
        d = (c * c).sum(1, keepdim=True) + pp - 2 * c @ pal.T  # exact: whole numbers < 2^53
        first = d.argmin(1, keepdim=True)
        best = d.gather(1, first)
        own = d.gather(1, b[:, None])
        pick = torch.where(own == best, b[:, None], first)[:, 0]
        tied = ((own != best) & ((d == best).sum(1, keepdim=True) > 1))[:, 0].nonzero()[:, 0]
        if len(tied):  # several nearest entries, none the box's own: Quant.c's search order
            key = torch.where(d[tied] == best[tied], rank[b[tied]], float("inf"))
            pick[tied] = key.argmin(1)
        out[s:s + _CHUNK] = pick
    return out


def quantize(frame) -> Tuple[np.ndarray, np.ndarray]:
    """An (H, W, 3) RGB u8 frame (numpy, or a tensor on its device) →
    (indices (H, W) u8, palette (m, 3) u8, m <= 256): Pillow's
    ``convert("P", palette=ADAPTIVE)``."""
    import torch

    t = frame if isinstance(frame, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(frame))
    h, w = t.shape[:2]
    px = t.reshape(-1, 3).to(torch.int64)
    keys, inverse, counts = torch.unique((px[:, 0] << 16) | (px[:, 1] << 8) | px[:, 2],
                                         return_inverse=True, return_counts=True)
    _scale, cols, coarse_counts, coarse = coarse_histogram(keys, counts)
    box_of, m = median_cut(cols, coarse_counts)
    box = torch.from_numpy(box_of).to(t.device)[coarse]
    distinct = torch.stack(_channels(keys), 1)
    palette = palette_of(distinct, counts, box, m)
    idx = nearest(distinct, box, palette)[inverse]
    return idx.to(torch.uint8).reshape(h, w).cpu().numpy(), palette
