"""Non-local means denoising (port of ``rustcv_tpu.ops.nlmeans``; OpenCV
``fastNlMeansDenoising`` /
``fastNlMeansDenoisingColored`` role, Buades et al. 2005).

The reference has no photo module; OpenCV-parity addition, spec frozen
here with a float64 NumPy oracle (:func:`nl_means_numpy`).

The port
--------
For every search offset ``s`` the patch distance field
``D_s = box_{templ}( (I − shift_s(I))² )`` and its weight
``w_s = exp(−D_s / (h²·n_templ))`` are whole-image elementwise maps, as
in the reference, which runs them as a ``lax.scan`` over the (2r+1)²
offsets. Here the offsets go one search row at a time, the row's 2r+1
column offsets as one batch on the image's device: each batch is stacked
shifted views, one squared difference, the template box (taps added in
the reference's order) and one ``exp``, then summed into the
(numerator, denominator) pair. The batch sum changes the float32 order of
summation against the reference's one-offset-at-a-time scan (±1 LSB, the
bar). The division happens once at the end.

Frozen spec (oracle float64):
- pad the image by ``search//2 + template//2`` with edge replication;
- ``D_s(p) = Σ_{t∈templ} (I(p+t) − I(p+s+t))²`` (replicate border);
- ``w_s(p) = exp(−D_s(p) / (h² · n_templ))`` — the centre offset s=0
  participates naturally with weight 1;
- ``out(p) = round( Σ_s w_s·I(p+s) / Σ_s w_s )`` clipped to u8.

The colored variant converts to CIE Lab (ops/color.py), denoises L with
``h`` and a/b with ``h_color``, and converts back — OpenCV's exact
decomposition (modules/photo/src/denoising.cpp role).

Tolerance contract: device f32 vs f64 oracle — output u8 within ±1 LSB
(tests/test_nlmeans.py); weights are well-conditioned (exp of negative
bounded arguments).
"""

from __future__ import annotations

import numpy as np
import torch

from .filters import _replicate_pad
from .tensors import as_tensor


def _edge_pad(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate-pad the last two axes by ``pad``."""
    return _replicate_pad(_replicate_pad(a, a.ndim - 2, pad), a.ndim - 1, pad)


def nl_means_numpy(img: np.ndarray, h: float = 10.0, template: int = 7,
                   search: int = 21) -> np.ndarray:
    """Oracle — the frozen spec above in float64 NumPy. (H, W) u8 → u8."""
    hh, ww = img.shape
    sr, tr = search // 2, template // 2
    pad = sr + tr
    p = np.pad(img.astype(np.float64), pad, mode="edge")
    base = p[sr:sr + hh + 2 * tr, sr:sr + ww + 2 * tr]  # I with templ apron
    n_templ = template * template
    inv = 1.0 / (h * h * n_templ)
    num = np.zeros((hh, ww))
    den = np.zeros((hh, ww))
    for sy in range(-sr, sr + 1):
        for sx in range(-sr, sr + 1):
            shifted = p[sr + sy:sr + sy + hh + 2 * tr,
                        sr + sx:sr + sx + ww + 2 * tr]
            d2 = (base - shifted) ** 2
            # box sum over the template window
            acc = np.zeros((hh, ww))
            for ty in range(template):
                for tx in range(template):
                    acc += d2[ty:ty + hh, tx:tx + ww]
            w = np.exp(-acc * inv)
            num += w * shifted[tr:tr + hh, tr:tr + ww]
            den += w
    return np.clip(np.floor(num / den + 0.5), 0, 255).astype(np.uint8)


def _box_valid(a: torch.Tensor, t: int) -> torch.Tensor:
    """Sum of every t×t window of ``a [..., H + t − 1, W + t − 1]`` →
    [..., H, W], taps added in the reference's order (columns, then rows)."""
    hh, ww = a.shape[-2] - t + 1, a.shape[-1] - t + 1
    acc = a[..., 0:ww]
    for k in range(1, t):
        acc = acc + a[..., k:k + ww]
    out = acc[..., 0:hh, :]
    for k in range(1, t):
        out = out + acc[..., k:k + hh, :]
    return out


def _accumulate(num, den, base, p, sr: int, tr: int, inv: float, hh: int, ww: int):
    """Add the weights and weighted samples of the search offsets of the
    padded frame ``p`` into ``num``/``den``, one search row at a time (all
    its column offsets as one batch)."""
    tw, th = ww + 2 * tr, hh + 2 * tr
    search = 2 * sr + 1
    for sy in range(search):
        rows = p[sy:sy + th]
        shifted = torch.stack([rows[:, sx:sx + tw] for sx in range(search)])
        d = base - shifted
        acc = _box_valid(d * d, 2 * tr + 1)
        wgt = torch.exp(-acc * inv)
        num += (wgt * shifted[:, tr:tr + hh, tr:tr + ww]).sum(0)
        den += wgt.sum(0)


def _finish(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(num / den + 0.5), 0, 255).to(torch.uint8)


def nl_means(img, h: float = 10.0, template: int = 7,
             search: int = 21) -> torch.Tensor:
    """Device twin — (H, W) u8 → u8 on the image's device (numpy goes to
    the card), float32 internals."""
    a = as_tensor(img)
    hh, ww = a.shape
    sr, tr = search // 2, template // 2
    pad = sr + tr
    p = _edge_pad(a.to(torch.float32), pad)
    base = p[sr:sr + hh + 2 * tr, sr:sr + ww + 2 * tr]
    inv = float(np.float32(1.0 / (h * h * template * template)))
    num = torch.zeros((hh, ww), dtype=torch.float32, device=a.device)
    den = torch.zeros_like(num)
    _accumulate(num, den, base, p, sr, tr, inv, hh, ww)
    return _finish(num, den)


def nl_means_colored(bgr, h: float = 10.0, h_color: float = 10.0,
                     template: int = 7, search: int = 21) -> torch.Tensor:
    """(H, W, 3) u8 BGR → u8: denoise L with ``h``, a/b with ``h_color``
    in CIE Lab, convert back (OpenCV fastNlMeansDenoisingColored role)."""
    from .color import bgr_to_lab, lab_to_bgr

    lab = bgr_to_lab(as_tensor(bgr))
    ell = nl_means(lab[..., 0], h, template, search)
    a = nl_means(lab[..., 1], h_color, template, search)
    b = nl_means(lab[..., 2], h_color, template, search)
    return lab_to_bgr(torch.stack([ell, a, b], dim=-1))


def nl_means_multi_numpy(frames: np.ndarray, img_index: int,
                         temporal_window: int, h: float = 10.0,
                         template: int = 7, search: int = 21
                         ) -> np.ndarray:
    """Oracle for the temporal variant (OpenCV
    ``fastNlMeansDenoisingMulti`` role): denoise ``frames[img_index]``
    with patches drawn from the ``temporal_window`` frames centred on
    it — the SAME spec as nl_means_numpy with the search set extended
    across time (the reference frame's own s=0 keeps weight 1)."""
    if temporal_window % 2 == 0:
        raise ValueError("temporal_window must be odd")
    half = temporal_window // 2
    if not (half <= img_index < len(frames) - half):
        raise ValueError("temporal window leaves the stack")
    hh, ww = frames[img_index].shape
    sr, tr = search // 2, template // 2
    pad = sr + tr
    base_p = np.pad(frames[img_index].astype(np.float64), pad,
                    mode="edge")
    base = base_p[sr:sr + hh + 2 * tr, sr:sr + ww + 2 * tr]
    n_templ = template * template
    inv = 1.0 / (h * h * n_templ)
    num = np.zeros((hh, ww))
    den = np.zeros((hh, ww))
    for f in range(img_index - half, img_index + half + 1):
        pf = np.pad(frames[f].astype(np.float64), pad, mode="edge")
        for sy in range(-sr, sr + 1):
            for sx in range(-sr, sr + 1):
                shifted = pf[sr + sy:sr + sy + hh + 2 * tr,
                             sr + sx:sr + sx + ww + 2 * tr]
                d2 = (base - shifted) ** 2
                acc = np.zeros((hh, ww))
                for ty in range(template):
                    for tx in range(template):
                        acc += d2[ty:ty + hh, tx:tx + ww]
                w = np.exp(-acc * inv)
                num += w * shifted[tr:tr + hh, tr:tr + ww]
                den += w
    return np.clip(np.floor(num / den + 0.5), 0, 255).astype(np.uint8)


def nl_means_multi(frames, img_index: int, temporal_window: int,
                   h: float = 10.0, template: int = 7,
                   search: int = 21) -> torch.Tensor:
    """Device twin — (T, H, W) u8 stack on its device (numpy goes to the
    card); the (frame, offset) pairs in the reference's order."""
    st = as_tensor(frames)
    if temporal_window % 2 == 0:
        raise ValueError("temporal_window must be odd")
    half = temporal_window // 2
    if not (half <= img_index < st.shape[0] - half):
        raise ValueError("temporal window leaves the stack")
    hh, ww = st.shape[1], st.shape[2]
    sr, tr = search // 2, template // 2
    pad = sr + tr
    base = _edge_pad(st[img_index].to(torch.float32), pad)[sr:sr + hh + 2 * tr,
                                                           sr:sr + ww + 2 * tr]
    inv = float(np.float32(1.0 / (h * h * template * template)))
    num = torch.zeros((hh, ww), dtype=torch.float32, device=st.device)
    den = torch.zeros_like(num)
    for f in range(img_index - half, img_index + half + 1):
        p = _edge_pad(st[f].to(torch.float32), pad)
        _accumulate(num, den, base, p, sr, tr, inv, hh, ww)
    return _finish(num, den)


def nl_means_colored_multi_numpy(frames: np.ndarray, img_index: int,
                                 temporal_window: int, h: float = 10.0,
                                 h_color: float = 10.0,
                                 template: int = 7, search: int = 21
                                 ) -> np.ndarray:
    """Colored temporal variant (OpenCV
    ``fastNlMeansDenoisingColoredMulti`` role): Lab split — L denoised
    with the temporal spec at ``h``, a/b at ``h_color`` (OpenCV's
    decomposition, as in the single-frame colored path)."""
    from .golden import bgr_to_lab, lab_to_bgr

    labs = np.stack([bgr_to_lab(np.asarray(f)) for f in frames])
    out = np.zeros_like(labs[img_index])
    for c, hh_ in ((0, h), (1, h_color), (2, h_color)):
        out[..., c] = nl_means_multi_numpy(
            labs[..., c], img_index, temporal_window, h=hh_,
            template=template, search=search)
    return lab_to_bgr(out)
