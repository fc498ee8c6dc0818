"""PNG row filters as Pillow 12's encoder chooses them (``ZipEncode.c``),
run on the image's device.

For each row Pillow tries None (0), Up (2), Sub (1) and Paeth (4), in that
order, scores each filtered row by the sum of ``min(v, 256 - v)`` over its
bytes, and keeps a later candidate only where its score is strictly lower:
a tie goes to the earlier one (an all-zero row keeps None; Up beats Sub).
It never tries Average (3). Every candidate depends only on the raw bytes
(the byte ``bpp`` to the left, the one above, the one above that), so the
four are one elementwise pass over the whole image: no loop over rows. A
card Mat is filtered on the card, and only the filtered bytes (one byte a
row more than the image) go to the host for zlib.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ORDER = (0, 2, 1, 4)  # None, Up, Sub, Paeth: the order Pillow tries them
_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)  # a 1-bit row's pixels, most significant bit first


def raw_rows(img: torch.Tensor, depth: int) -> torch.Tensor:
    """An (H, W) or (H, W, C) image → its rows as PNG packs them, (H, row
    bytes) int32: bytes for ``depth`` 8; big-endian byte pairs of samples
    0-65535 for 16; for 1, a bool (H, W) image packed 8 pixels a byte, the
    first in the high bit, the last byte padded with zeros."""
    h, w = img.shape[:2]
    if depth == 1:
        bits = F.pad(img.reshape(h, w).to(torch.int32), (0, -w % 8)).reshape(h, -1, 8)
        shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.int32, device=img.device)
        return (bits << shifts).sum(-1, dtype=torch.int32)
    v = img.reshape(h, -1).to(torch.int32)
    if depth == 16:
        return torch.stack([v >> 8, v & 255], -1).reshape(h, -1)
    return v


def filter_rows(img: torch.Tensor, depth: int) -> torch.Tensor:
    """An (H, W) or (H, W, C) image on any device (u8 for ``depth`` 8,
    integer samples 0-65535 for 16, bool for 1) → the PNG image data before
    zlib, (H, 1 + row bytes) u8 on the same device: each row's filter type,
    then the row filtered by it, as Pillow chooses."""
    ch = 1 if img.ndim == 2 else int(img.shape[2])
    bpp = max(1, depth * ch // 8)
    r = raw_rows(img, depth)
    h, n = r.shape
    a = F.pad(r[:, :n - bpp], (bpp, 0))  # left
    b = F.pad(r[:-1], (0, 0, 1, 0))  # above
    c = F.pad(b[:, :n - bpp], (bpp, 0))  # upper left
    pa, pb, pc = (b - c).abs(), (a - c).abs(), (a + b - 2 * c).abs()
    paeth = torch.where((pa <= pb) & (pa <= pc), a, torch.where(pb <= pc, b, c))
    cand = torch.stack([r, r - b, r - a, r - paeth]) & 255  # in ORDER
    score = torch.minimum(cand, 256 - cand).sum(-1, dtype=torch.int32)  # (4, H)
    best = score.argmin(0)  # the first of equal scores: Pillow's tie order
    rows = cand.gather(0, best.view(1, h, 1).expand(1, h, n))[0]
    kind = torch.tensor(ORDER, dtype=torch.int32, device=img.device)[best]
    return torch.cat([kind[:, None], rows], 1).to(torch.uint8)
