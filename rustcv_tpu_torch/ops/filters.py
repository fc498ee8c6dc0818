"""Stencil filters (port of ``rustcv_tpu.ops.filters``): the pipeline's
5×5 Gaussian, 3×3 Sobel, exact integer gradient magnitude and Canny, and
the rest of the module (pyramids, morphology, medians, thresholds, box and
stack blurs, the bilateral filter, Laplacian, Scharr, ``filter2D``,
integral images, directional derivatives), each equal to the reference's
frozen spec in ``golden`` (``filter2d_u8`` within its stated tolerance).

Integer taps are shifted adds on replicate-padded int32 tensors. The chain
``gaussian5_u8 → sobel3_gray → gradient_magnitude_u8`` is the plain version
of the blur+Sobel kernel (:mod:`.kernels.stencil`), including its two-stage
border rule: the Gaussian replicates the original at the border, then the
Sobel replicates the blurred image.
"""

from __future__ import annotations

import numpy as np
import torch

GAUSS5 = (1, 4, 6, 4, 1)  # per-axis taps, sum 16
# Bounded hysteresis rounds of Canny: the frozen spec's constant
# (rustcv_tpu/ops/golden.py:999), copied because importing the JAX package's
# ops loads jax.
CANNY_HYST_ROUNDS = 16


def _replicate_pad(a: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    n = a.shape[axis]
    idx = torch.arange(-r, n + r, device=a.device).clamp(0, n - 1)
    return a.index_select(axis, idx)


def _taps(a: torch.Tensor, axis: int, weights, r: int) -> torch.Tensor:
    """Σ w_k · shift_k(a) along ``axis`` with replicate border, int32."""
    p = _replicate_pad(a, axis, r)
    n = a.shape[axis]
    acc = None
    for k, w in enumerate(weights):
        if w == 0:
            continue
        sl = p.narrow(axis, k, n)
        term = w * sl if w != 1 else sl
        acc = term if acc is None else acc + term
    return acc


def _spatial_axes(img: torch.Tensor, has_channels=None):
    """(ax_h, ax_w) as non-negative axes: (-3, -2) when a trailing channel
    axis of 1, 3 or 4 entries is present (guessed when ``has_channels`` is
    None, as the reference guesses), else (-2, -1)."""
    if has_channels is None:
        has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    return (img.ndim - 3, img.ndim - 2) if has_channels else (img.ndim - 2, img.ndim - 1)


def gaussian5_u8(img: torch.Tensor, has_channels: bool = None) -> torch.Tensor:  # type: ignore[assignment]
    """5×5 Gaussian on u8, replicate border, (Σ+128)>>8. The spatial axes
    are the last two, or (-3, -2) when a trailing channel axis is present
    (guessed as in the reference when ``has_channels`` is None)."""
    ax_h, ax_w = _spatial_axes(img, has_channels)
    a = img.to(torch.int32)
    tmp = _taps(a, ax_w, GAUSS5, 2)
    acc = _taps(tmp, ax_h, GAUSS5, 2)
    return ((acc + 128) >> 8).to(torch.uint8)


def sobel3_gray(gray: torch.Tensor):
    """Sobel gx/gy on u8 gray (..., H, W) → int32 pair."""
    a = gray.to(torch.int32)
    ax_h, ax_w = a.ndim - 2, a.ndim - 1
    smooth_v = _taps(a, ax_h, (1, 2, 1), 1)
    diff_v = _taps(a, ax_h, (-1, 0, 1), 1)
    gx = _taps(smooth_v, ax_w, (-1, 0, 1), 1)
    gy = _taps(diff_v, ax_w, (1, 2, 1), 1)
    return gx, gy


def isqrt_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact floor-sqrt of non-negative int32 (f32 sqrt + two fix-ups)."""
    s = x.to(torch.float32).sqrt().to(torch.int32)
    s = torch.where((s + 1) * (s + 1) <= x, s + 1, s)
    s = torch.where(s * s > x, s - 1, s)
    return s


def gradient_magnitude_u8(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """min(255, isqrt(gx²+gy²)); |gx|, |gy| ≤ 1020 so the sum fits int32."""
    mag2 = gx * gx + gy * gy
    return isqrt_exact(mag2).clamp(max=255).to(torch.uint8)


def blur_sobel_mag_u8(gray: torch.Tensor) -> torch.Tensor:
    """gray u8 (..., H, W) → Gaussian5 → Sobel → |∇| u8 (..., H, W)."""
    blurred = gaussian5_u8(gray, has_channels=False)
    return gradient_magnitude_u8(*sobel3_gray(blurred))


def _window_reduce(img: torch.Tensor, ksize: int, fn) -> torch.Tensor:
    """fn-reduce over a ksize×ksize window, replicate border, on the axes of
    :func:`_spatial_axes`."""
    return _masked_window_reduce(img, np.ones((ksize, ksize), bool), fn)


def canny_u8(gray: torch.Tensor, low: int = 40, high: int = 90) -> torch.Tensor:
    """Canny edges on u8 gray (..., H, W) → u8 mask (255/0), bit-exact with
    the frozen integer spec (``golden.canny``): Gaussian5 → Sobel → exact
    |∇| → fixed-point sector NMS (out-of-image neighbours 0) → double
    threshold → CANNY_HYST_ROUNDS rounds of 3×3 hysteresis growth."""
    blurred = gaussian5_u8(gray, has_channels=False)
    gx, gy = sobel3_gray(blurred)
    mag = isqrt_exact(gx * gx + gy * gy)

    a = gx.abs()
    b = gy.abs()
    sector0 = (b << 16) <= a * 27146  # ~horizontal gradient (tan 22.5°)
    sector2 = (b << 16) >= a * 158218  # ~vertical gradient (tan 67.5°)
    diagonal = ~sector0 & ~sector2
    diag_main = diagonal & (gx * gy >= 0)
    diag_anti = diagonal & (gx * gy < 0)

    h, w = mag.shape[-2], mag.shape[-1]
    p = mag.new_zeros((*mag.shape[:-2], h + 2, w + 2))
    p[..., 1:-1, 1:-1] = mag

    def nb(dy, dx):
        return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    zero = torch.zeros((), dtype=mag.dtype, device=mag.device)
    n1 = torch.where(sector0, nb(0, -1), zero)
    n2 = torch.where(sector0, nb(0, 1), zero)
    n1 = torch.where(sector2, nb(-1, 0), n1)
    n2 = torch.where(sector2, nb(1, 0), n2)
    n1 = torch.where(diag_main, nb(-1, -1), n1)
    n2 = torch.where(diag_main, nb(1, 1), n2)
    n1 = torch.where(diag_anti, nb(-1, 1), n1)
    n2 = torch.where(diag_anti, nb(1, -1), n2)
    nms = torch.where((mag >= n1) & (mag >= n2), mag, zero)

    strong = (nms > high).to(torch.uint8)
    weak = nms > low
    for _ in range(CANNY_HYST_ROUNDS):
        grown = _window_reduce(strong * 255, 3, torch.maximum) > 0
        strong = torch.where(weak & grown, torch.ones_like(strong), strong)
    return strong * 255


# -- the rest of the reference's filters (frozen integer specs in golden) ------


def pyr_down(img: torch.Tensor, has_channels: bool = None) -> torch.Tensor:  # type: ignore[assignment]
    """Pyramid downsample: 5×5 Gaussian and even-index decimation
    (golden.pyr_down); ceil(H/2) × ceil(W/2)."""
    ax_h, ax_w = _spatial_axes(img, has_channels)
    blurred = gaussian5_u8(img, has_channels=ax_h == img.ndim - 3)
    idx_h = torch.arange(0, img.shape[ax_h], 2, device=img.device)
    idx_w = torch.arange(0, img.shape[ax_w], 2, device=img.device)
    return blurred.index_select(ax_h, idx_h).index_select(ax_w, idx_w)


def erode_u8(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """k×k erosion (window min), replicate border (golden.erode)."""
    return _window_reduce(img, ksize, torch.minimum)


def dilate_u8(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """k×k dilation (window max), replicate border (golden.dilate)."""
    return _window_reduce(img, ksize, torch.maximum)


# Elements of one median's window stack per chunk of rows: bounds the
# widened (int16) copy of the windows to 128 MiB at any image size.
_MEDIAN_CHUNK = 1 << 26


def median_u8(img: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k×k median (odd k), replicate border: the k²//2-th order statistic of
    each window (golden.median_k), exact. The windows of a band of rows
    (``unfold``) are widened to int16 and reduced by ``kthvalue``, band by
    band."""
    if k % 2 != 1 or k < 1:
        raise ValueError(f"median_u8: odd k required, got {k}")
    ax_h, ax_w = _spatial_axes(img)
    r = k // 2
    p = _replicate_pad(_replicate_pad(img, ax_h, r), ax_w, r)
    h = img.shape[ax_h]
    per_row = max(1, img.numel() // max(h, 1)) * k * k  # window elements per image row
    rows = max(1, _MEDIAN_CHUNK // per_row)
    bands = []
    for y0 in range(0, h, rows):
        n = min(rows, h - y0)
        win = p.narrow(ax_h, y0, n + 2 * r).unfold(ax_h, k, 1).unfold(ax_w, k, 1)
        win = win.to(torch.int16).reshape(*win.shape[:-2], k * k)
        bands.append(win.kthvalue(k * k // 2 + 1, dim=-1).values)
    return torch.cat(bands, dim=ax_h).to(torch.uint8)


def median3_u8(img: torch.Tensor) -> torch.Tensor:
    """3×3 median by Smith's median-of-9 exchange network (19
    compare-exchanges), exact (golden.median3)."""
    ax_h, ax_w = _spatial_axes(img)
    p = _replicate_pad(_replicate_pad(img, ax_h, 1), ax_w, 1)
    h, w = img.shape[ax_h], img.shape[ax_w]
    t = [p.narrow(ax_h, dy, h).narrow(ax_w, dx, w) for dy in range(3) for dx in range(3)]
    for a, b in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8),
                 (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4), (4, 2)):
        t[a], t[b] = torch.minimum(t[a], t[b]), torch.maximum(t[a], t[b])
    return t[4]


THRESHOLD_TYPES = ("binary", "binary_inv", "trunc", "tozero", "tozero_inv")


def threshold_u8(img: torch.Tensor, thresh, maxval, type: str = "binary") -> torch.Tensor:
    """Element-wise threshold, strict ``> thresh`` (golden.threshold);
    ``thresh`` and ``maxval`` are numbers or 0-d tensors."""
    if type not in THRESHOLD_TYPES:
        raise ValueError(f"unknown threshold type {type!r}")
    a = img.to(torch.int32)
    thresh = torch.as_tensor(thresh, dtype=torch.int32, device=img.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int32, device=img.device)
    zero = torch.zeros_like(a)
    above = a > thresh
    out = {"binary": lambda: torch.where(above, maxval, zero),
           "binary_inv": lambda: torch.where(above, zero, maxval),
           "trunc": lambda: torch.where(above, thresh, a),
           "tozero": lambda: torch.where(above, a, zero),
           "tozero_inv": lambda: torch.where(above, zero, a)}[type]()
    return out.clamp(0, 255).to(torch.uint8)


def _stackblur_mul_shr(r: int) -> tuple:
    """StackBlur's fixed-point divider for div=(r+1)²: shr = 9 +
    floor(log2(div)), mul = ceil(2^shr / div) (the classic table from its
    defining formula)."""
    div = (r + 1) * (r + 1)
    shr = 9 + (div.bit_length() - 1)
    mul = -(-(1 << shr) // div)
    return mul, shr


def _tri_sum(a: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    """Σ_{|i|≤r} (r+1−|i|)·a[x+i] along ``axis``, replicate border, int64:
    two box sums of length r+1 by prefix sums (a triangle is box∗box)."""
    if r == 0:
        return a
    p = _replicate_pad(a, axis, r)
    n = a.shape[axis]

    def prefix(x):  # c[i] = Σ x[:i]
        c = torch.cumsum(x, dim=axis, dtype=torch.int64)
        return torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], dim=axis)

    c = prefix(p)
    b1 = c.narrow(axis, r + 1, n + r) - c.narrow(axis, 0, n + r)
    c2 = prefix(b1)
    return c2.narrow(axis, r + 1, n) - c2.narrow(axis, 0, n)


def stack_blur_u8(img: torch.Tensor, kw: int, kh: int = None) -> torch.Tensor:  # type: ignore[assignment]
    """StackBlur (separable triangle, replicate border): per pass
    (tri_sum · mul) >> shr with the stackblur divider (golden.stack_blur_u8).
    kw, kh odd, ≤ 255."""
    if kh is None:
        kh = kw
    if kw % 2 == 0 or kh % 2 == 0 or kw > 255 or kh > 255:
        raise ValueError("stack_blur_u8: odd ksize ≤ 255 required")
    ax_h, ax_w = _spatial_axes(img)
    mul, shr = _stackblur_mul_shr(kw // 2)
    h = (_tri_sum(img.to(torch.int64), ax_w, kw // 2) * mul) >> shr
    mul, shr = _stackblur_mul_shr(kh // 2)
    return ((_tri_sum(h, ax_h, kh // 2) * mul) >> shr).to(torch.uint8)


def _box_sum(a: torch.Tensor, ax_h: int, ax_w: int, ksize: int) -> torch.Tensor:
    ones = (1,) * ksize
    return _taps(_taps(a, ax_w, ones, ksize // 2), ax_h, ones, ksize // 2)


def box_blur_u8(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Box blur k×k (odd k), replicate border, the rounded integer mean."""
    ax_h, ax_w = _spatial_axes(img)
    n = ksize * ksize
    return ((_box_sum(img.to(torch.int32), ax_h, ax_w, ksize) + n // 2) // n).to(torch.uint8)


def _gray_only(gray: torch.Tensor, what: str) -> None:
    if gray.ndim >= 3 and gray.shape[-1] in (1, 3, 4):
        raise ValueError(f"{what}: gray (H, W) input required")


def adaptive_threshold_u8(gray: torch.Tensor, maxval: int = 255, method: str = "mean",
                          block: int = 11, c: int = 2, inv: bool = False) -> torch.Tensor:
    """Adaptive threshold (golden.adaptive_threshold): T = the block×block
    rounded box mean or the 5×5 Gaussian; maxval where value > T − c (or
    not, with ``inv``). Gray (..., H, W) only."""
    _gray_only(gray, "adaptive_threshold_u8")
    a = gray.to(torch.int32)
    if method == "mean":
        n = block * block
        t = (_box_sum(a, a.ndim - 2, a.ndim - 1, block) + n // 2) // n
    elif method == "gaussian":
        t = gaussian5_u8(gray, has_channels=False).to(torch.int32)
    else:
        raise ValueError(f"unknown method {method!r} (mean, gaussian)")
    above = a > t - c
    if inv:
        above = ~above
    return (above.to(torch.int32) * maxval).to(torch.uint8)


def bilateral5_u8(gray: torch.Tensor, sigma: int = 25) -> torch.Tensor:
    """5×5 bilateral filter (golden.bilateral5_u8): binomial spatial
    weights times the integer range ramp max(0, 64 − d²//S), S =
    max(1, 2σ²//64), normalized by exact floor division. Gray only."""
    _gray_only(gray, "bilateral5_u8")
    a = gray.to(torch.int32)
    h, w = a.shape[-2], a.shape[-1]
    p = _replicate_pad(_replicate_pad(a, a.ndim - 2, 2), a.ndim - 1, 2)
    s_range = max(1, (2 * sigma * sigma) // 64)
    num = torch.zeros_like(a)
    den = torch.zeros_like(a)
    for dy in range(5):
        for dx in range(5):
            v = p[..., dy:dy + h, dx:dx + w]
            d = (v - a).abs()
            wt = GAUSS5[dy] * GAUSS5[dx] * (64 - (d * d) // s_range).clamp(min=0)
            num = num + wt * v
            den = den + wt
    out = torch.div(num + den // 2, den, rounding_mode="floor")
    return out.clamp(0, 255).to(torch.uint8)


def laplacian3(gray: torch.Tensor) -> torch.Tensor:
    """3×3 Laplacian → int32, replicate border (golden.laplacian3)."""
    a = gray.to(torch.int32)
    ax_h, ax_w = a.ndim - 2, a.ndim - 1
    return _taps(a, ax_h, (1, 0, 1), 1) + _taps(a, ax_w, (1, 0, 1), 1) - 4 * a


def scharr3_gray(gray: torch.Tensor):
    """Scharr gx/gy on u8 gray (..., H, W) → int32 pair
    (golden.scharr3_gray)."""
    a = gray.to(torch.int32)
    ax_h, ax_w = a.ndim - 2, a.ndim - 1
    gx = _taps(_taps(a, ax_h, (3, 10, 3), 1), ax_w, (-1, 0, 1), 1)
    gy = _taps(_taps(a, ax_w, (3, 10, 3), 1), ax_h, (-1, 0, 1), 1)
    return gx, gy


MORPH_OPS = ("open", "close", "gradient", "tophat", "blackhat")


def morphology_ex_u8(img: torch.Tensor, op: str, ksize: int = 3) -> torch.Tensor:
    """Compound morphology (OpenCV ``morphologyEx``; golden.morphology_ex);
    every difference is non-negative."""
    if op == "open":
        return dilate_u8(erode_u8(img, ksize), ksize)
    if op == "close":
        return erode_u8(dilate_u8(img, ksize), ksize)
    if op == "gradient":
        return dilate_u8(img, ksize) - erode_u8(img, ksize)
    if op == "tophat":
        return img - morphology_ex_u8(img, "open", ksize)
    if op == "blackhat":
        return morphology_ex_u8(img, "close", ksize) - img
    raise ValueError(f"unknown morphology op {op!r} (one of {MORPH_OPS})")


def filter2d_u8(img: torch.Tensor, kernel) -> torch.Tensor:
    """Arbitrary-kernel correlation (OpenCV ``filter2D``; golden.filter2d),
    replicate border: float32 shifted-view accumulation, round half to
    even, saturate to u8. Exact for dyadic kernels that are not rank 1
    (integer/2^k taps keep float32 sums exact); ±1 LSB otherwise. A rank-1
    kernel runs separably, its factors from the SVD (as the reference's);
    an all-zero kernel gives zeros (the reference's separable path fails
    on it). ``kernel`` is a host (odd, odd) array."""
    k = np.ascontiguousarray(kernel, np.float64)
    if k.ndim != 2 or k.shape[0] % 2 == 0 or k.shape[1] % 2 == 0:
        raise ValueError("kernel must be 2-D with odd sides")
    kh, kw = k.shape
    ax_h, ax_w = _spatial_axes(img)
    f = img.to(torch.float32)
    u, s, vt = np.linalg.svd(k)
    if s[0] > 0 and s[1:].max(initial=0.0) < 1e-12 * s[0]:  # rank 1
        ky = [float(x) for x in u[:, 0] * np.sqrt(s[0])]
        kx = [float(x) for x in vt[0] * np.sqrt(s[0])]
        acc = _taps(_taps(f, ax_w, kx, kw // 2), ax_h, ky, kh // 2)
    else:
        p = _replicate_pad(_replicate_pad(f, ax_h, kh // 2), ax_w, kw // 2)
        h, w = img.shape[ax_h], img.shape[ax_w]
        acc = None
        for dy in range(kh):
            for dx in range(kw):
                wgt = float(k[dy, dx])
                if wgt == 0.0:
                    continue
                term = wgt * p.narrow(ax_h, dy, h).narrow(ax_w, dx, w)
                acc = term if acc is None else acc + term
    if acc is None:
        acc = torch.zeros_like(f)
    return torch.round(acc).clamp(0, 255).to(torch.uint8)


def integral_u8(img: torch.Tensor) -> torch.Tensor:
    """Summed-area table (H+1, W+1) int64 of a single-channel (H, W) image
    with a zero top row and left column (golden.integral), exact at any
    size."""
    if img.ndim != 2:
        raise ValueError("integral expects a single-channel (H, W) image")
    s = img.to(torch.int64).cumsum(0).cumsum(1)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


def pyr_up(img: torch.Tensor, has_channels: bool = None) -> torch.Tensor:  # type: ignore[assignment]
    """Pyramid upsample to (2H, 2W) (golden.pyr_up): per axis the polyphase
    binomial on the source (even = [1, 6, 1], odd = [4, 4]; replicate
    border), interleaved, then (Σ + 32) >> 6."""
    ax_h, ax_w = _spatial_axes(img, has_channels)

    def up_axis(a, axis):
        n = a.shape[axis]
        p = _replicate_pad(a, axis, 1)
        right = p.narrow(axis, 2, n)
        even = p.narrow(axis, 0, n) + 6 * a + right
        odd = 4 * (a + right)
        out = torch.stack([even, odd], dim=axis + 1)
        shape = list(a.shape)
        shape[axis] *= 2
        return out.reshape(shape)

    acc = up_axis(up_axis(img.to(torch.int32), ax_w), ax_h)
    return ((acc + 32) >> 6).clamp(0, 255).to(torch.uint8)


def get_structuring_element(shape: str, ksize: int) -> np.ndarray:
    """Morphology kernels (OpenCV ``getStructuringElement``): bool (k, k)
    numpy mask. "rect" (all ones), "cross" (centre row and column),
    "ellipse" (inscribed disc: |dx| <= r·sqrt(1-(dy/r)²) rounded)."""
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError("ksize must be odd and positive")
    r = ksize // 2
    if shape == "rect":
        return np.ones((ksize, ksize), bool)
    if shape == "cross":
        m = np.zeros((ksize, ksize), bool)
        m[r, :] = True
        m[:, r] = True
        return m
    if shape == "ellipse":
        m = np.zeros((ksize, ksize), bool)
        rr = max(r, 1)
        for dy in range(-r, r + 1):
            t = 1.0 - (dy / rr) ** 2
            dx = int(round(rr * np.sqrt(max(t, 0.0)))) if r > 0 else 0
            m[dy + r, r - dx: r + dx + 1] = True
        return m
    raise ValueError(f"unknown shape {shape!r} (rect, cross, ellipse)")


def _masked_window_reduce(img: torch.Tensor, kernel, fn) -> torch.Tensor:
    """fn-reduce over the True offsets of ``kernel`` (any kh×kw bool mask),
    replicate border."""
    k = np.asarray(kernel, bool)
    kh, kw = k.shape
    ax_h, ax_w = _spatial_axes(img)
    p = _replicate_pad(_replicate_pad(img, ax_h, kh // 2), ax_w, kw // 2)
    h, w = img.shape[ax_h], img.shape[ax_w]
    acc = None
    for dy, dx in zip(*np.nonzero(k)):
        sl = p.narrow(ax_h, int(dy), h).narrow(ax_w, int(dx), w)
        acc = sl if acc is None else fn(acc, sl)
    if acc is None:
        raise ValueError("structuring element has no True cells")
    return acc


def erode_kernel_u8(img: torch.Tensor, kernel) -> torch.Tensor:
    """Erosion over an arbitrary structuring element (a host bool mask;
    golden.erode_kernel)."""
    return _masked_window_reduce(img, kernel, torch.minimum)


def dilate_kernel_u8(img: torch.Tensor, kernel) -> torch.Tensor:
    """Dilation over an arbitrary structuring element."""
    return _masked_window_reduce(img, kernel, torch.maximum)


def deriv_kernels(dx: int, dy: int, ksize: int):
    """Integer separable Sobel kernels (kx, ky) int64 for derivative orders
    (dx, dy), odd ``ksize`` ≥ 3 (OpenCV ``getDerivKernels``): the binomial
    row convolved ``ksize − 1 − order`` times with [1, 1], then ``order``
    times with [−1, 1] (ksize 3: order 0 → [1, 2, 1], 1 → [−1, 0, 1],
    2 → [1, −2, 1])."""
    if ksize % 2 == 0 or ksize < 3:
        raise ValueError("ksize must be odd and >= 3")
    if dx + dy < 1 or dx > 2 or dy > 2:
        raise ValueError("derivative orders must satisfy 1 <= dx+dy, <= 2 each")

    def kernel(order: int):
        k = np.array([1.0])
        for _ in range(ksize - 1 - order):
            k = np.convolve(k, [1.0, 1.0])
        for _ in range(order):
            k = np.convolve(k, [-1.0, 1.0])
        return k.astype(np.int64)

    return kernel(dx), kernel(dy)


def sobel_xy_numpy(gray: np.ndarray, dx: int, dy: int, ksize: int = 3) -> np.ndarray:
    """Oracle: exact int64 separable correlation, replicate border."""
    kx, ky = deriv_kernels(dx, dy, ksize)
    a = np.asarray(gray, np.int64)
    r = ksize // 2
    p = np.pad(a, ((0, 0), (r, r)), mode="edge")
    out = np.zeros_like(a)
    for k, w in enumerate(kx):
        if w:
            out += w * p[:, k:k + a.shape[1]]
    p = np.pad(out, ((r, r), (0, 0)), mode="edge")
    out2 = np.zeros_like(a)
    for k, w in enumerate(ky):
        if w:
            out2 += w * p[k:k + a.shape[0], :]
    return out2


def sobel_xy(gray: torch.Tensor, dx: int, dy: int, ksize: int = 3) -> torch.Tensor:
    """Directional derivative of u8 gray (..., H, W) → int32, exact
    (values bounded by 255·4^(ksize−1))."""
    kx, ky = deriv_kernels(dx, dy, ksize)
    a = gray.to(torch.int32)
    out = _taps(a, a.ndim - 1, [int(w) for w in kx], ksize // 2)
    return _taps(out, a.ndim - 2, [int(w) for w in ky], ksize // 2)
