"""RGB(A) → Y, U, V (4:2:0) and alpha for the WebP encoder, on the image's
own device: libwebp's import without sharp YUV (``ImportYUVAFromRGBA`` in
``picture_csp_enc.c``), which Pillow's save runs, in exact integer
arithmetic, so a card tensor and a CPU tensor give the same planes.

* Y per pixel: ``VP8RGBToY`` (16.16 fixed point, ``YUV_HALF`` rounding).
* U and V per 2x2 block (the last row and column repeated where the size is
  odd): the four pixels' values through libwebp's gamma table
  (``kGammaToLinearTab``, gamma 0.8 on a 12-bit scale) summed, back through
  the interpolated inverse table (``LinearToGamma``), then ``VP8RGBToU`` and
  ``VP8RGBToV`` at 2 more bits of precision. Where a block is partly
  transparent (its alpha sum neither 0 nor 4 x 255), the sum is weighted by
  alpha (``LinearToGammaWeighted``: sum(a x linear) times libwebp's
  ``kInvAlpha[sum(a)]`` = 2^19 // sum(a), shifted right by 17).

A card image downloads only the planes (1.5 bytes a pixel, and the alpha).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# kGammaToLinearTab and kLinearToGammaTab (GAMMA_FIX 12, GAMMA_TAB_FIX 7)
_GAMMA_TO_LINEAR = [int(pow(v / 255.0, 0.8) * 4095 + 0.5) for v in range(256)]
_LINEAR_TO_GAMMA = [int(255.0 * pow((128 / 4095) * v, 1 / 0.8) + 0.5) for v in range(33)]
_INV_ALPHA = [0] + [(1 << 19) // a for a in range(1, 4 * 255 + 1)]  # kInvAlpha
_tables: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}


def _device_tables(device: torch.device) -> Tuple[torch.Tensor, ...]:
    t = _tables.get(device)
    if t is None:
        t = (torch.tensor(_GAMMA_TO_LINEAR, dtype=torch.int32, device=device),
             torch.tensor(_LINEAR_TO_GAMMA, dtype=torch.int32, device=device),
             torch.tensor(_INV_ALPHA, dtype=torch.int64, device=device))
        _tables[device] = t
    return t


def _even(x: torch.Tensor) -> torch.Tensor:
    """(H, W, ...) with the last row and column repeated to even sides."""
    if x.shape[0] & 1:
        x = torch.cat([x, x[-1:]], 0)
    if x.shape[1] & 1:
        x = torch.cat([x, x[:, -1:]], 1)
    return x


def _quads(x: torch.Tensor) -> torch.Tensor:
    return x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]


def _clip_uv(v: torch.Tensor) -> torch.Tensor:  # VP8ClipUV at YUV_FIX + 2
    return ((v + (1 << 17) + (128 << 18)) >> 18).clamp_(0, 255).to(torch.uint8)


def import_yuva(rgb: torch.Tensor, alpha: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W, 3) u8 RGB (and an (H, W) u8 alpha, or None) on any device →
    (Y (H, W), U, V ((H + 1) // 2, (W + 1) // 2)) u8 on that device."""
    g2l, l2g, inv_alpha = _device_tables(rgb.device)
    x = rgb.to(torch.int32)
    r, g, b = x.unbind(-1)
    y = ((16839 * r + 33059 * g + 6420 * b + (1 << 15) + (16 << 16)) >> 16).to(torch.uint8)
    lin = g2l[_even(rgb).long()]  # (H2, W2, 3)
    total = _quads(lin)
    if alpha is not None:
        a = _even(alpha).to(torch.int32)
        a_sum = _quads(a)
        weighted = ((_quads(lin * a[..., None]).long() * inv_alpha[a_sum.long()][..., None])
                    >> 17).to(torch.int32)
        partly = (a_sum > 0) & (a_sum < 4 * 255)
        total = torch.where(partly[..., None], weighted, total)
    pos, frac = total >> 9, total & 511  # LinearToGamma: interpolated, then descaled
    val = (l2g[pos + 1] * frac + l2g[pos] * (512 - frac) + 64) >> 7
    r, g, b = val.unbind(-1)
    u = _clip_uv(-9719 * r - 19081 * g + 28800 * b)
    v = _clip_uv(28800 * r - 24116 * g - 4684 * b)
    return y, u, v
