"""Core array operations (OpenCV ``copyMakeBorder`` / ``split`` /
``merge`` / ``mixChannels`` / ``cartToPolar`` / ``polarToCart`` /
``magnitude`` / ``phase`` / ``compare`` / ``findNonZero`` / ``reduce`` /
``sort`` / ``sortIdx`` / ``hconcat`` / ``vconcat`` / ``repeat`` /
``transform`` / ``perspectiveTransform`` / ``getAffineTransform`` /
``gemm`` / ``scaleAdd`` / ``setIdentity`` / ``invert`` / ``solve`` /
``determinant`` / ``eigen`` / ``SVDecomp`` / ``PCACompute`` /
``calcCovarMatrix`` / ``Mahalanobis`` / ``randu`` / ``randn`` roles).

Port of ``rustcv_tpu.ops.core_ops``. The image-scale ops take a numpy
array (computed on the host, as the reference's numpy path) or a torch
tensor (computed on the tensor's device, in float32 where the reference's
device path is float32: the reference's ``jax.Array`` path); small-matrix
linear algebra, the RNG and the other host helpers are float64 numpy, as
in the reference.

Frozen specs (validated against OpenCV 5.0 in tests/test_core_ops.py):
- copy_make_border: the five border types map exactly onto np.pad modes
  (constant / edge / symmetric / reflect / wrap) — bit-exact;
- fast_atan2: OpenCV's 7th-order minimax polynomial in degrees (the
  public constants), max error ≲0.3°; ``cart_to_polar`` / ``phase`` use
  it in BOTH degree and radian modes exactly as OpenCV does;
- polar_to_cart: f64 sin/cos oracle; OpenCV's table-interpolated SinCos
  differs by ≲1e-5 rel — documented tolerance;
- randu: bit-exact replica of cv::RNG's multiply-with-carry generator
  (state' = 4164903690·lo32(state) + hi32(state)); integer fill is
  ``a + next() % (b-a)``, float fill is ``(int32)next()·2⁻³² + ½`` scaled
  — both verified value-for-value against cv2.setRNGSeed/cv2.randu;
- randn: OUR frozen spec (Box-Muller pairs over the same MWC stream) —
  OpenCV's table-based gaussian is NOT reproduced, only the moments.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# borders

_BORDER_TO_PAD = {
    "replicate": "edge",
    "reflect": "symmetric",
    "reflect101": "reflect",
    "reflect_101": "reflect",
    "default": "reflect",
    "wrap": "wrap",
}


def _pad_index(n: int, before: int, after: int, mode: str) -> np.ndarray:
    """Source index of each padded position along an axis of length ``n``
    under np.pad's ``mode`` (edge, symmetric, reflect, wrap)."""
    p = np.arange(-before, n + after)
    if mode == "edge":
        return np.clip(p, 0, n - 1)
    if mode == "wrap":
        return p % n
    if mode == "symmetric":
        q = p % (2 * n)
        return np.where(q >= n, 2 * n - 1 - q, q)
    if n == 1:  # reflect
        return np.zeros_like(p)
    per = 2 * n - 2
    q = p % per
    return np.where(q >= n, per - q, q)


def copy_make_border(src, top: int, bottom: int, left: int, right: int,
                     border_type: str = "constant", value=0):
    """OpenCV ``copyMakeBorder``. Works on numpy arrays or tensors (on the
    tensor's device: a gather of host-built indices, or a fill); extra
    trailing channel axes are padded with zero-width borders."""
    if min(top, bottom, left, right) < 0:
        raise ValueError("border widths must be non-negative")
    pad = [(top, bottom), (left, right)] + [(0, 0)] * (src.ndim - 2)
    if border_type == "constant":
        if not torch.is_tensor(src):
            return np.pad(src, pad, mode="constant", constant_values=value)
        h, w = src.shape[0], src.shape[1]
        out = torch.full((h + top + bottom, w + left + right) + tuple(src.shape[2:]), value,
                         dtype=src.dtype, device=src.device)
        out[top:top + h, left:left + w] = src
        return out
    mode = _BORDER_TO_PAD.get(border_type)
    if mode is None:
        raise ValueError(f"unknown border_type {border_type!r}")
    if not torch.is_tensor(src):
        return np.pad(src, pad, mode=mode)
    rows = torch.from_numpy(_pad_index(src.shape[0], top, bottom, mode)).to(src.device)
    cols = torch.from_numpy(_pad_index(src.shape[1], left, right, mode)).to(src.device)
    return src.index_select(0, rows).index_select(1, cols)


def _cast(a, dtype):
    """``a`` as ``dtype`` (a numpy or torch dtype, matching ``a``)."""
    return a.to(dtype) if torch.is_tensor(a) else a.astype(dtype)


# ---------------------------------------------------------------------------
# channel plumbing

def split(m):
    """OpenCV ``split``: (H, W, C) → list of C single-channel arrays."""
    if m.ndim != 3:
        raise ValueError("split expects an (H, W, C) array")
    return [m[..., c] for c in range(m.shape[2])]


def merge_channels(channels: Sequence):
    """OpenCV ``merge``: list of (H, W) planes → (H, W, C)."""
    if torch.is_tensor(channels[0]):
        return torch.stack(list(channels), dim=-1)
    return np.stack(list(channels), axis=-1)


def mix_channels(srcs: Sequence, n_dst_channels: Sequence[int],
                 from_to: Sequence[int]):
    """OpenCV ``mixChannels``: reroute source channel j (global index
    over the concatenated src channel list) into destination channel k.
    ``from_to`` is the flat [src0, dst0, src1, dst1, ...] pair list;
    ``n_dst_channels`` gives each output's channel count. A src index of
    -1 zero-fills the destination channel."""
    if len(from_to) % 2:
        raise ValueError("from_to must be (src, dst) pairs")
    planes: List = []
    for s in srcs:
        planes.extend([s] if s.ndim == 2 else split(s))
    h, w = planes[0].shape
    dt = planes[0].dtype
    if torch.is_tensor(planes[0]):
        dev = planes[0].device

        def zeros():
            return torch.zeros((h, w), dtype=dt, device=dev)
    else:
        def zeros():
            return np.zeros((h, w), dt)
    n_total = int(sum(n_dst_channels))
    out_planes: List = [zeros() for _ in range(n_total)]
    for i in range(0, len(from_to), 2):
        sj, dk = int(from_to[i]), int(from_to[i + 1])
        out_planes[dk] = (zeros() if sj < 0 else planes[sj])
    outs, k = [], 0
    for n in n_dst_channels:
        outs.append(merge_channels(out_planes[k:k + n]) if n > 1
                    else out_planes[k])
        k += n
    return outs


# ---------------------------------------------------------------------------
# polar <-> cartesian (fastAtan2 frozen spec)

# OpenCV's public minimax fit for atan on [0, 1], output in degrees.
_ATAN2_P1 = 0.9997878412794807 * (180.0 / np.pi)
_ATAN2_P3 = -0.3258083974640975 * (180.0 / np.pi)
_ATAN2_P5 = 0.1555786518463281 * (180.0 / np.pi)
_ATAN2_P7 = -0.04432655554792128 * (180.0 / np.pi)
_DBL_EPS = float(np.finfo(np.float64).eps)


def _fast_atan2_t(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`_fast_atan2` in float32 on the tensors' device (the constants
    rounded to float32 as there)."""
    f32 = torch.float32
    y = y.to(f32)
    x = x.to(f32)
    ax, ay = x.abs(), y.abs()
    lo, hi = torch.minimum(ax, ay), torch.maximum(ax, ay)
    c = lo / (hi + float(np.float32(_DBL_EPS)))
    c2 = c * c
    p7, p5, p3, p1 = (float(np.float32(v)) for v in (_ATAN2_P7, _ATAN2_P5, _ATAN2_P3, _ATAN2_P1))
    a = ((p7 * c2 + p5) * c2 + p3) * c2 * c + p1 * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    a = torch.where(y < 0, 360.0 - a, a)
    return a


def _fast_atan2(y, x):
    """Degrees in [0, 360). f32 arithmetic like OpenCV's (numpy)."""
    f = np.float32
    y = y.astype(f)
    x = x.astype(f)
    ax, ay = np.abs(x), np.abs(y)
    lo, hi = np.minimum(ax, ay), np.maximum(ax, ay)
    c = lo / (hi + f(_DBL_EPS))
    c2 = c * c
    a = ((f(_ATAN2_P7) * c2 + f(_ATAN2_P5)) * c2
         + f(_ATAN2_P3)) * c2 * c + f(_ATAN2_P1) * c
    a = np.where(ax >= ay, a, f(90.0) - a)
    a = np.where(x < 0, f(180.0) - a, a)
    a = np.where(y < 0, f(360.0) - a, a)
    return a


def fast_atan2(y, x):
    """OpenCV ``fastAtan2`` (degrees, ≈0.3° accuracy). Scalar or array; a
    tensor argument computes on its device."""
    if torch.is_tensor(y) or torch.is_tensor(x):
        dev = y.device if torch.is_tensor(y) else x.device
        return _fast_atan2_t(torch.as_tensor(y, device=dev), torch.as_tensor(x, device=dev))
    out = _fast_atan2(np.asarray(y, np.float32), np.asarray(x, np.float32))
    return float(out) if np.ndim(y) == 0 and np.ndim(x) == 0 else out


def magnitude(x, y):
    """OpenCV ``magnitude``: √(x² + y²), elementwise, float32."""
    if torch.is_tensor(x):
        return torch.sqrt(x.to(torch.float32) ** 2 + y.to(torch.float32) ** 2)
    return np.sqrt(x.astype(np.float32) ** 2 + y.astype(np.float32) ** 2)


def phase(x, y, angle_in_degrees: bool = False):
    """OpenCV ``phase``: the fastAtan2 angle of (x, y). OpenCV uses the
    polynomial in radian mode too (scaled by π/180) — so do we."""
    if torch.is_tensor(x):
        deg = _fast_atan2_t(y, x)
        return deg if angle_in_degrees else deg * float(np.float32(np.pi / 180.0))
    deg = _fast_atan2(y, x)
    return deg if angle_in_degrees else deg * np.float32(np.pi / 180.0)


def cart_to_polar(x, y, angle_in_degrees: bool = False):
    """OpenCV ``cartToPolar`` → (magnitude, angle)."""
    return magnitude(x, y), phase(x, y, angle_in_degrees)


def polar_to_cart(mag, angle, angle_in_degrees: bool = False):
    """OpenCV ``polarToCart`` → (x, y). f64 sin/cos spec on the host
    (OpenCV's table-interpolated SinCos agrees to ≲1e-5 rel); float32 on a
    tensor's device."""
    if torch.is_tensor(mag):
        a = angle.to(torch.float32)
        if angle_in_degrees:
            a = a * (np.pi / 180.0)
        return ((mag * torch.cos(a)).to(torch.float32),
                (mag * torch.sin(a)).to(torch.float32))
    a = angle.astype(np.float64)
    if angle_in_degrees:
        a = a * (np.pi / 180.0)
    return ((mag * np.cos(a)).astype(np.float32),
            (mag * np.sin(a)).astype(np.float32))


# ---------------------------------------------------------------------------
# comparisons / scans

_CMP = {
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
}


def compare(a, b, op: str):
    """OpenCV ``compare``: elementwise predicate → u8 mask (255/0)."""
    if op not in _CMP:
        raise ValueError(f"unknown op {op!r} (one of {sorted(_CMP)})")
    if torch.is_tensor(a):
        return _CMP[op](a, b).to(torch.uint8) * 255
    return _CMP[op](a, b).astype(np.uint8) * np.uint8(255)


def find_non_zero(m: np.ndarray) -> np.ndarray:
    """OpenCV ``findNonZero``: (N, 2) int32 points as (x, y), raster
    scan order. Host op (the output is inherently ragged)."""
    ys, xs = np.nonzero(np.asarray(m))
    return np.stack([xs, ys], axis=1).astype(np.int32)


def reduce_mat(m, dim: int, rtype: str = "sum"):
    """OpenCV ``reduce``: collapse rows (dim=0 → one row) or columns
    (dim=1 → one column) by sum / avg / max / min. Sums/averages
    accumulate in f64 on host, f32 on a tensor's device."""
    if dim not in (0, 1):
        raise ValueError("dim must be 0 (rows) or 1 (cols)")
    if torch.is_tensor(m):
        if rtype in ("sum", "avg"):
            acc = m.to(torch.float32)
            out = acc.mean(dim=dim) if rtype == "avg" else acc.sum(dim=dim)
        elif rtype == "max":
            out = m.amax(dim=dim)
        elif rtype == "min":
            out = m.amin(dim=dim)
        else:
            raise ValueError(f"unknown rtype {rtype!r}")
        return out[None, :] if dim == 0 else out[:, None]
    if rtype in ("sum", "avg"):
        acc = m.astype(np.float64)
        out = acc.mean(axis=dim) if rtype == "avg" else acc.sum(axis=dim)
    elif rtype == "max":
        out = m.max(axis=dim)
    elif rtype == "min":
        out = m.min(axis=dim)
    else:
        raise ValueError(f"unknown rtype {rtype!r}")
    return out[None, :] if dim == 0 else out[:, None]


def sort_mat(m, axis: int = 1, descending: bool = False):
    """OpenCV ``sort`` (SORT_EVERY_ROW ↔ axis=1, SORT_EVERY_COLUMN ↔
    axis=0), stable."""
    if torch.is_tensor(m):
        out = torch.sort(m, dim=axis, stable=True).values
        return torch.flip(out, dims=(axis,)) if descending else out
    out = np.sort(m, axis=axis, kind="stable")
    return np.flip(out, axis=axis) if descending else out


def sort_idx(m, axis: int = 1, descending: bool = False):
    """OpenCV ``sortIdx``: argsort indices, stable ascending; descending
    sorts -keys stably (OpenCV's descending order of equal keys)."""
    key = -m if descending else m
    if torch.is_tensor(m):
        return torch.argsort(key, dim=axis, stable=True).to(torch.int32)
    return np.argsort(key, axis=axis, kind="stable").astype(np.int32)


def hconcat(mats: Sequence):
    if torch.is_tensor(mats[0]):
        return torch.cat(list(mats), dim=1)
    return np.concatenate(list(mats), axis=1)


def vconcat(mats: Sequence):
    if torch.is_tensor(mats[0]):
        return torch.cat(list(mats), dim=0)
    return np.concatenate(list(mats), axis=0)


def repeat_mat(m, ny: int, nx: int):
    """OpenCV ``repeat``: tile ny × nx."""
    reps = (ny, nx) + (1,) * (m.ndim - 2)
    if torch.is_tensor(m):
        return torch.tile(m, reps)
    return np.tile(m, reps)


# ---------------------------------------------------------------------------
# point-set transforms

def transform_points(pts, m):
    """OpenCV ``transform`` on an (N, d) point set with an (r, d) or
    (r, d+1) matrix (the +1 column is an additive offset)."""
    pts = np.asarray(pts, np.float64)
    m = np.asarray(m, np.float64)
    d = pts.shape[-1]
    if m.shape[1] == d:
        return pts @ m.T
    if m.shape[1] == d + 1:
        return pts @ m[:, :d].T + m[:, d]
    raise ValueError(f"matrix shape {m.shape} does not match points "
                     f"of dim {d}")


def perspective_transform(pts, m):
    """OpenCV ``perspectiveTransform``: (N, d) points through an
    (d+1, d+1) homography, perspective divide included."""
    pts = np.asarray(pts, np.float64)
    m = np.asarray(m, np.float64)
    d = pts.shape[-1]
    if m.shape != (d + 1, d + 1):
        raise ValueError(f"matrix must be {(d + 1, d + 1)} for {d}-D points")
    h = np.concatenate([pts, np.ones((*pts.shape[:-1], 1))], axis=-1) @ m.T
    return h[..., :d] / h[..., d:d + 1]


def get_affine_transform(src, dst) -> np.ndarray:
    """OpenCV ``getAffineTransform``: exact 2×3 affine from 3 point
    pairs (solves the 6×6 system in f64)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != (3, 2) or dst.shape != (3, 2):
        raise ValueError("need exactly 3 source and 3 destination points")
    a = np.concatenate([src, np.ones((3, 1))], axis=1)
    coeffs = np.linalg.solve(a, dst)  # (3, 2)
    return coeffs.T  # (2, 3)


# ---------------------------------------------------------------------------
# small-matrix linear algebra (host f64, like ops/calib.py)

def gemm(a, b, alpha: float = 1.0, c=None, beta: float = 0.0,
         transpose_a: bool = False, transpose_b: bool = False,
         transpose_c: bool = False):
    """OpenCV ``gemm``: α·op(A)·op(B) + β·op(C) (numpy or 2-D tensors)."""
    at = a.T if transpose_a else a
    bt = b.T if transpose_b else b
    out = alpha * (at @ bt)
    if c is not None and beta != 0.0:
        out = out + beta * (c.T if transpose_c else c)
    return out


def scale_add(a, alpha: float, b):
    """OpenCV ``scaleAdd``: α·A + B."""
    return alpha * a + b


def set_identity(shape: Tuple[int, int], value: float = 1.0,
                 dtype=np.float64) -> np.ndarray:
    """OpenCV ``setIdentity``: value on the diagonal, 0 elsewhere."""
    out = np.zeros(shape, dtype)
    np.fill_diagonal(out, value)
    return out


def determinant(m) -> float:
    return float(np.linalg.det(np.asarray(m, np.float64)))


def invert(m, method: str = "lu") -> Tuple[float, np.ndarray]:
    """OpenCV ``invert``. ``lu``: (nonzero-determinant flag, inverse);
    ``svd``: (σ_min/σ_max, Moore-Penrose pseudo-inverse) — OpenCV's
    return-value conventions."""
    m = np.asarray(m, np.float64)
    if method == "lu":
        det = np.linalg.det(m)
        if abs(det) < np.finfo(np.float64).tiny:
            return 0.0, np.zeros_like(m.T)
        return 1.0, np.linalg.inv(m)
    if method == "svd":
        u, s, vt = np.linalg.svd(m, full_matrices=False)
        ratio = float(s[-1] / s[0]) if s[0] > 0 else 0.0
        keep = s > s[0] * max(m.shape) * np.finfo(np.float64).eps
        sinv = np.where(keep, 1.0 / np.where(keep, s, 1.0), 0.0)
        return ratio, (vt.T * sinv) @ u.T
    raise ValueError(f"unknown method {method!r}")


def solve(a, b, method: str = "lu") -> Tuple[bool, np.ndarray]:
    """OpenCV ``solve``: ``lu`` exact square solve; ``svd``/``qr``/
    ``normal`` least squares."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if b.ndim == 1:
        b = b[:, None]
    if method == "lu":
        if abs(np.linalg.det(a)) < np.finfo(np.float64).tiny:
            return False, np.zeros((a.shape[1], b.shape[1]))
        return True, np.linalg.solve(a, b)
    if method in ("svd", "qr", "normal"):
        x, *_ = np.linalg.lstsq(a, b, rcond=None)
        return True, x
    raise ValueError(f"unknown method {method!r}")


def eigen(m) -> Tuple[bool, np.ndarray, np.ndarray]:
    """OpenCV ``eigen`` (symmetric input): eigenvalues descending,
    eigenvectors as ROWS (OpenCV layout)."""
    m = np.asarray(m, np.float64)
    w, v = np.linalg.eigh(m)
    order = np.argsort(w)[::-1]
    return True, w[order], v[:, order].T


def sv_decomp(m) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV ``SVDecomp`` → (w, u, vt), singular values descending."""
    u, s, vt = np.linalg.svd(np.asarray(m, np.float64), full_matrices=False)
    return s[:, None], u, vt


def sv_back_subst(w, u, vt, rhs) -> np.ndarray:
    """OpenCV ``SVBackSubst``: x = V diag(1/w) Uᵀ b with zeroed tiny w."""
    s = np.asarray(w, np.float64).ravel()
    keep = s > (s[0] * max(u.shape[0], vt.shape[1])
                * np.finfo(np.float64).eps if s.size else 0.0)
    sinv = np.where(keep, 1.0 / np.where(keep, s, 1.0), 0.0)
    rhs = np.asarray(rhs, np.float64)
    if rhs.ndim == 1:
        rhs = rhs[:, None]
    return vt.T @ (sinv[:, None] * (u.T @ rhs))


# ---------------------------------------------------------------------------
# statistics

def calc_covar_matrix(samples, rows_as_samples: bool = True,
                      scrambled: bool = False, scale: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV ``calcCovarMatrix`` (COVAR_ROWS layout) → (covar, mean).
    COVAR_NORMAL = (X-μ)ᵀ(X-μ); ``scrambled`` gives COVAR_SCRAMBLED's
    (X-μ)(X-μ)ᵀ; ``scale`` divides by the sample count."""
    x = np.asarray(samples, np.float64)
    if not rows_as_samples:
        x = x.T
    mu = x.mean(axis=0)
    d = x - mu
    cov = d @ d.T if scrambled else d.T @ d
    if scale:
        cov /= x.shape[0]
    return cov, mu


def mahalanobis(v1, v2, icovar) -> float:
    """OpenCV ``Mahalanobis``: √((v1-v2)ᵀ·icovar·(v1-v2))."""
    d = np.asarray(v1, np.float64).ravel() - np.asarray(v2, np.float64).ravel()
    return float(np.sqrt(d @ np.asarray(icovar, np.float64) @ d))


def pca_compute(data, mean: Optional[np.ndarray] = None,
                max_components: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV ``PCACompute`` (DATA_AS_ROW) → (mean, eigenvectors as
    rows, eigenvalues descending)."""
    x = np.asarray(data, np.float64)
    mu = x.mean(axis=0) if mean is None else np.asarray(mean, np.float64).ravel()
    d = x - mu
    # SVD route: numerically better than forming the covariance.
    _, s, vt = np.linalg.svd(d, full_matrices=False)
    eigvals = (s ** 2) / x.shape[0]
    if max_components and max_components < vt.shape[0]:
        vt = vt[:max_components]
        eigvals = eigvals[:max_components]
    return mu, vt, eigvals


def pca_project(data, mean, eigenvectors) -> np.ndarray:
    x = np.asarray(data, np.float64)
    return (x - np.asarray(mean, np.float64)) @ np.asarray(
        eigenvectors, np.float64).T


def pca_back_project(proj, mean, eigenvectors) -> np.ndarray:
    return np.asarray(proj, np.float64) @ np.asarray(
        eigenvectors, np.float64) + np.asarray(mean, np.float64)


# ---------------------------------------------------------------------------
# RNG (cv::RNG multiply-with-carry, bit-exact)

_MWC_A = 4164903690


class RNG:
    """Bit-exact replica of cv::RNG (multiply-with-carry). ``randu``
    fills match cv2.setRNGSeed + cv2.randu value-for-value (integer AND
    float paths — see module docstring); ``gaussian`` is our own frozen
    Box-Muller spec over the same stream."""

    def __init__(self, seed: int = 0xFFFFFFFF):
        # cv::RNG(0) silently becomes the default seed — keep that quirk.
        self.state = seed if seed else 0xFFFFFFFF

    def next(self) -> int:
        self.state = (_MWC_A * (self.state & 0xFFFFFFFF)
                      + (self.state >> 32)) & 0xFFFFFFFFFFFFFFFF
        return self.state & 0xFFFFFFFF

    def uniform_int(self, a: int, b: int) -> int:
        return a + self.next() % (b - a) if b > a else a

    def uniform_float(self, a: float, b: float) -> float:
        v = self.next()
        signed = v - (1 << 32) if v >= (1 << 31) else v
        return float(np.float32(
            (signed * 2.0 ** -32 + 0.5) * (b - a) + a))

    def randu(self, shape: Tuple[int, ...], low, high,
              dtype=np.float32) -> np.ndarray:
        """Row-major fill, one draw per element (cv2.randu order)."""
        n = int(np.prod(shape))
        if np.issubdtype(np.dtype(dtype), np.integer):
            flat = np.fromiter(
                (self.uniform_int(int(low), int(high)) for _ in range(n)),
                np.int64, n)
        else:
            flat = np.fromiter(
                (self.uniform_float(float(low), float(high))
                 for _ in range(n)), np.float64, n)
        return flat.astype(dtype).reshape(shape)

    def gaussian(self, sigma: float = 1.0) -> float:
        """Frozen Box-Muller over the MWC stream (our spec)."""
        while True:
            u1 = self.uniform_float(0.0, 1.0)
            u2 = self.uniform_float(0.0, 1.0)
            if u1 > 1e-12:
                break
        r = np.sqrt(-2.0 * np.log(u1))
        return float(r * np.cos(2.0 * np.pi * u2) * sigma)

    def randn(self, shape: Tuple[int, ...], mean: float, stddev: float,
              dtype=np.float32) -> np.ndarray:
        n = int(np.prod(shape))
        flat = np.fromiter(
            (mean + self.gaussian(stddev) for _ in range(n)), np.float64, n)
        return flat.astype(dtype).reshape(shape)


# ---------------------------------------------------------------------------
# round-3b completeness batch (cross-validated against cv2 5.0 in
# tests/test_core_ops2.py)

def accumulate(src, dst, mask=None):
    """OpenCV ``accumulate``: dst + src (float dst), returned (we are
    functional — cv2 mutates in place)."""
    if torch.is_tensor(dst):
        add = torch.as_tensor(src, device=dst.device).to(dst.dtype)
        if mask is not None:
            m = torch.as_tensor(mask, device=dst.device).to(torch.bool)
            add = torch.where(m, add, torch.zeros_like(add))
        return dst + add
    add = src.astype(dst.dtype)
    if mask is not None:
        add = np.where(mask.astype(bool), add, np.zeros_like(add))
    return dst + add


def accumulate_square(src, dst, mask=None):
    s = _cast(src, dst.dtype)
    return accumulate(s * s, dst, mask)


def accumulate_product(src1, src2, dst, mask=None):
    s = _cast(src1, dst.dtype) * _cast(src2, dst.dtype)
    return accumulate(s, dst, mask)


def blend_linear(src1, src2, w1, w2):
    """OpenCV ``blendLinear``: (src1·w1 + src2·w2)/(w1+w2+ε), float32;
    u8 in → u8 out (round half to even)."""
    if torch.is_tensor(src1):
        f32 = torch.float32

        def w(v):
            return torch.as_tensor(v, dtype=f32, device=src1.device)

        num = src1.to(f32) * w(w1) + src2.to(f32) * w(w2)
        out = num / (w(w1 + w2) + 1e-5)
        if src1.dtype == torch.uint8:
            return torch.round(out).clamp(0, 255).to(torch.uint8)
        return out
    num = (src1.astype(np.float32) * w1 + src2.astype(np.float32) * w2)
    out = num / (w1 + w2 + np.float32(1e-5))
    if src1.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out


def box_filter(src, ksize, normalize: bool = True,
               border_type: str = "reflect101"):
    """OpenCV ``boxFilter``/``blur`` (normalize=True) /
    ``sqrBoxFilter``-style sums (normalize=False → float64 sums on the
    host, float32 on a tensor's device). Any (kw, kh); exact vs cv2 for u8
    inputs."""
    kh, kw = (ksize, ksize) if np.isscalar(ksize) else (ksize[1],
                                                        ksize[0])
    is_t = torch.is_tensor(src)
    a = src.to(torch.float32) if is_t else src.astype(np.float64)
    ry, rx = kh // 2, kw // 2
    p = copy_make_border(a, ry, kh - 1 - ry, rx, kw - 1 - rx,
                         border_type)
    h, w = src.shape[:2]
    out = torch.zeros_like(a) if is_t else np.zeros_like(a)
    for dy in range(kh):
        for dx in range(kw):
            out = out + p[dy:dy + h, dx:dx + w]
    if normalize:
        out = out / (kh * kw)
        if is_t and src.dtype == torch.uint8:
            return torch.round(out).clamp(0, 255).to(torch.uint8)
        if not is_t and src.dtype == np.uint8:
            return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out


def blur(src, ksize, border_type: str = "reflect101"):
    """OpenCV ``blur``: normalized box filter."""
    return box_filter(src, ksize, True, border_type)


def sqr_box_filter(src, ksize, normalize: bool = True,
                   border_type: str = "reflect101"):
    """OpenCV ``sqrBoxFilter``: box filter of squared values (f64 on the
    host, f32 on a tensor's device)."""
    a = src.to(torch.float32) if torch.is_tensor(src) else src.astype(np.float64)
    return box_filter(a * a, ksize, normalize, border_type)


_HISTCMP = ("correl", "chisqr", "intersect", "bhattacharyya",
            "chisqr_alt", "kl_div")


def compare_hist(h1, h2, method: str = "correl") -> float:
    """OpenCV ``compareHist``: all six methods, float64."""
    a = np.asarray(h1, np.float64).ravel()
    b = np.asarray(h2, np.float64).ravel()
    if method == "correl":
        da = a - a.mean()
        db = b - b.mean()
        den = np.sqrt((da * da).sum() * (db * db).sum())
        return float((da * db).sum() / den) if den > 0 else 1.0
    if method == "chisqr":
        nz = a > 0
        return float((((a - b) ** 2)[nz] / a[nz]).sum())
    if method == "intersect":
        return float(np.minimum(a, b).sum())
    if method == "bhattacharyya":
        s = a.sum() * b.sum()
        if s <= 0:
            return 1.0
        bc = (np.sqrt(a * b)).sum() / np.sqrt(s)
        return float(np.sqrt(max(1.0 - bc, 0.0)))
    if method == "chisqr_alt":
        nz = (a + b) > 0
        return float(2.0 * (((a - b) ** 2)[nz] / (a + b)[nz]).sum())
    if method == "kl_div":
        out = 0.0
        for p, q in zip(a, b):
            if p > 0:
                out += p * np.log(p / max(q, 1e-10))
            elif q > 0:
                pass
        return float(out)
    raise ValueError(f"unknown method {method!r} (one of {_HISTCMP})")


def create_hanning_window(size: Tuple[int, int]) -> np.ndarray:
    """OpenCV ``createHanningWindow``: √(hann_row·hann_col) — the
    square-root separable form cv2 uses (black-box pinned)."""
    w, h = size
    i = np.arange(h, dtype=np.float64)
    j = np.arange(w, dtype=np.float64)
    wr = 0.5 * (1.0 - np.cos(2.0 * np.pi * i / max(h - 1, 1)))
    wc = 0.5 * (1.0 - np.cos(2.0 * np.pi * j / max(w - 1, 1)))
    return np.sqrt(wr[:, None] * wc[None, :]).astype(np.float32)


def cube_root(x):
    """OpenCV ``cubeRoot``: sign-preserving cube root. A tensor computes in
    float32 on its device (|x|^(1/3), then one Newton step)."""
    if not torch.is_tensor(x):
        return np.cbrt(x)
    x = x.to(torch.float32)
    y = torch.sign(x) * x.abs().pow(1.0 / 3.0)
    ok = torch.isfinite(y) & (y != 0)
    safe = torch.where(ok, y, 1.0)
    return torch.where(ok, y - (y * y * y - x) / (3.0 * safe * safe), y)


def convert_points_to_homogeneous(pts) -> np.ndarray:
    p = np.asarray(pts, np.float64).reshape(len(pts), -1)
    return np.concatenate([p, np.ones((len(p), 1))], axis=1)


def convert_points_from_homogeneous(pts) -> np.ndarray:
    p = np.asarray(pts, np.float64).reshape(len(pts), -1)
    w = p[:, -1:]
    w = np.where(np.abs(w) < 1e-300, 1.0, w)
    return p[:, :-1] / w


def complete_symm(m, lower_to_upper: bool = False) -> np.ndarray:
    """OpenCV ``completeSymm``: mirror one triangle onto the other."""
    a = np.asarray(m).copy()
    il = np.tril_indices_from(a, -1)
    if lower_to_upper:
        a[il[1], il[0]] = a[il]
    else:
        a[il] = a[il[1], il[0]]
    return a


def extract_channel(src, c: int):
    return src[..., c]


def insert_channel(src_plane, dst, c: int):
    if torch.is_tensor(dst):
        out = dst.clone()
        out[..., c] = torch.as_tensor(src_plane, device=dst.device)
        return out
    out = dst.copy()
    out[..., c] = src_plane
    return out


def has_non_zero(m) -> bool:
    if torch.is_tensor(m):
        return bool(torch.any(m != 0))
    return bool(np.any(m != 0))


def invert_affine_transform(m) -> np.ndarray:
    """OpenCV ``invertAffineTransform``: exact 2×3 inverse."""
    m = np.asarray(m, np.float64)
    a = m[:, :2]
    ainv = np.linalg.inv(a)
    return np.concatenate([ainv, -(ainv @ m[:, 2])[:, None]], axis=1)


def patch_nans(m, val: float = 0.0):
    if torch.is_tensor(m):
        return torch.where(torch.isnan(m), torch.tensor(val, dtype=m.dtype, device=m.device), m)
    return np.where(np.isnan(m), np.asarray(val, m.dtype), m)


def rand_shuffle(m, rng: "RNG") -> np.ndarray:
    """OpenCV ``randShuffle`` role over the pinned MWC stream
    (Fisher-Yates with uniform_int draws)."""
    a = np.asarray(m).copy()
    flat = a.reshape(-1)
    for i in range(len(flat) - 1, 0, -1):
        j = rng.uniform_int(0, i + 1)
        flat[i], flat[j] = flat[j], flat[i]
    return a


def reduce_arg_max(m, axis: int, last_index: bool = False):
    """OpenCV ``reduceArgMax``."""
    if torch.is_tensor(m):
        if last_index:
            n = m.shape[axis]
            idx = n - 1 - torch.argmax(torch.flip(m, dims=(axis,)), dim=axis)
        else:
            idx = torch.argmax(m, dim=axis)
        return idx.to(torch.int32).unsqueeze(axis)
    if last_index:
        n = m.shape[axis]
        rev = np.flip(m, axis=axis)
        idx = n - 1 - np.argmax(rev, axis=axis)
    else:
        idx = np.argmax(m, axis=axis)
    return np.expand_dims(idx.astype(np.int32), axis)


def reduce_arg_min(m, axis: int, last_index: bool = False):
    return reduce_arg_max(-m if torch.is_tensor(m) else -np.asarray(
        m, np.float64), axis, last_index)


def solve_cubic(coeffs) -> Tuple[int, np.ndarray]:
    """OpenCV ``solveCubic``: real roots of c0x³+c1x²+c2x+c3 (or the
    quadratic when c0=0) → (n_real_roots, roots ascending, padded 0)."""
    c = np.asarray(coeffs, np.float64).ravel()
    roots = np.roots(c if c[0] != 0 else c[1:])
    real = np.sort(roots[np.abs(roots.imag) < 1e-9].real)
    out = np.zeros(3)
    out[:len(real)] = real[:3]
    return int(len(real)), out


def solve_poly(coeffs) -> np.ndarray:
    """OpenCV ``solvePoly``: all complex roots of Σ c_i x^i
    (coefficients LOW order first, cv2's convention) → (N, 2) re/im,
    ascending by real part."""
    c = np.asarray(coeffs, np.float64).ravel()[::-1]
    r = np.roots(c)
    r = r[np.argsort(r.real, kind="stable")]
    return np.stack([r.real, r.imag], axis=1)


def trace(m) -> float:
    return float(np.trace(np.asarray(m, np.float64)))


def transpose_mat(m):
    if torch.is_tensor(m):
        return m.transpose(0, 1)
    return np.swapaxes(m, 0, 1)


def mul_transposed(m, a_t_a: bool = True, scale: float = 1.0
                   ) -> np.ndarray:
    """OpenCV ``mulTransposed``: AᵀA (default) or AAᵀ, scaled."""
    a = np.asarray(m, np.float64)
    return scale * (a.T @ a if a_t_a else a @ a.T)


def sum_elems(m):
    """OpenCV ``sum``: per-channel sums (f64)."""
    a = np.asarray(m, np.float64)
    if a.ndim == 2:
        return float(a.sum())
    return a.sum(axis=(0, 1))


def multiply_u8(a, b, scale: float = 1.0):
    """OpenCV ``multiply`` with u8 saturation + rounding (f64 on the host,
    f32 on a tensor's device)."""
    if torch.is_tensor(a):
        out = a.to(torch.float32) * b.to(torch.float32) * scale
        return torch.round(out).clamp(0, 255).to(torch.uint8)
    out = a.astype(np.float64) * b.astype(np.float64) * scale
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def divide_u8(a, b, scale: float = 1.0):
    """OpenCV ``divide`` with u8 saturation; x/0 = 0 (cv2 semantics)."""
    if torch.is_tensor(a):
        af = a.to(torch.float32)
        bf = b.to(torch.float32)
        out = torch.where(bf != 0, af * scale / torch.where(bf == 0, 1.0, bf), 0.0)
        return torch.round(out).clamp(0, 255).to(torch.uint8)
    af = a.astype(np.float64)
    bf = b.astype(np.float64)
    out = np.where(bf != 0, af * scale / np.where(bf == 0, 1, bf), 0.0)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# round-3b tail (tests/test_core_ops3.py)

def batch_distance(query, train, k: int = 1, norm: str = "l2"
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV ``batchDistance`` (crosscheck-free K-NN form): for each
    query row, the K nearest train rows → (dist (Q, K) f32,
    idx (Q, K) int32). Norms: l1, l2, hamming (uint8 rows)."""
    q = np.asarray(query)
    t = np.asarray(train)
    if norm == "hamming":
        x = np.unpackbits(q[:, None, :], axis=2)
        y = np.unpackbits(t[None, :, :], axis=2)
        d = (x != y).sum(axis=2).astype(np.float64)
    elif norm == "l1":
        d = np.abs(q[:, None, :].astype(np.float64)
                   - t[None, :, :]).sum(axis=2)
    elif norm == "l2":
        diff = q[:, None, :].astype(np.float64) - t[None, :, :]
        d = np.sqrt((diff * diff).sum(axis=2))
    else:
        raise ValueError(f"unknown norm {norm!r}")
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(d, idx, 1).astype(np.float32),
            idx.astype(np.int32))


def div_spectrums(a, b, conj_b: bool = False):
    """OpenCV ``divSpectrums`` (complex-array form): elementwise a/b,
    or a/conj(b) when ``conj_b``."""
    if torch.is_tensor(a):
        den = (b * torch.conj(b)).real
        num = a * b if conj_b else a * torch.conj(b)
        return num / den.clamp(min=1e-30)
    den = (b * np.conj(b)).real
    num = a * b if conj_b else a * np.conj(b)
    return num / np.maximum(den, 1e-30)


def eigen_non_symmetric(m) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV ``eigenNonSymmetric``: real eigenvalues descending,
    eigenvectors as rows."""
    w, v = np.linalg.eig(np.asarray(m, np.float64))
    order = np.argsort(-w.real, kind="stable")
    return w.real[order], v.real[:, order].T


def mat_mul_deriv(a, b) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV ``matMulDeriv``: Jacobians of vec(AB) wrt vec(A) and
    vec(B) (row-major vec, cv2's layout): dAB/dA = I_m ⊗ Bᵀ? — pinned
    against cv2 numerically in tests: d(AB)_{ij}/dA_{kl} = δ_ik B_lj,
    d(AB)_{ij}/dB_{kl} = A_ik δ_jl."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    m, n = a.shape
    n2, p = b.shape
    d_a = np.zeros((m * p, m * n))
    d_b = np.zeros((m * p, n * p))
    for i in range(m):
        for j in range(p):
            row = i * p + j
            d_a[row, i * n:(i + 1) * n] = b[:, j]
            d_b[row, j::p] = a[i]
    return d_a, d_b


def copy_to(src, mask, dst=None):
    """OpenCV ``copyTo`` with mask: dst pixels replaced where mask≠0."""
    if torch.is_tensor(src):
        dst = torch.zeros_like(src) if dst is None else torch.as_tensor(dst, device=src.device)
        m = torch.as_tensor(mask, device=src.device).to(torch.bool)
        if src.ndim == 3 and m.ndim == 2:
            m = m[..., None]
        return torch.where(m, src, dst)
    if dst is None:
        dst = np.zeros_like(src)
    m = mask.astype(bool)
    if src.ndim == 3 and m.ndim == 2:
        m = m[..., None]
    return np.where(m, src, dst)


def flip_nd(m, axis: int):
    if torch.is_tensor(m):
        return torch.flip(m, dims=(axis,))
    return np.flip(m, axis=axis)


def transpose_nd(m, order):
    if torch.is_tensor(m):
        return m.permute(tuple(order))
    return np.transpose(m, axes=tuple(order))


def finite_mask(m):
    """OpenCV ``finiteMask``: u8 255 where all channels finite."""
    if torch.is_tensor(m):
        ok = torch.isfinite(m)
        if m.ndim == 3:
            ok = ok.all(dim=-1)
        return ok.to(torch.uint8) * 255
    ok = np.isfinite(m)
    if m.ndim == 3:
        ok = ok.all(axis=-1)
    return ok.astype(np.uint8) * np.uint8(255)


def integral2(src) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV ``integral2``: (sum int64 (H+1, W+1), sqsum float64)."""
    a = np.asarray(src, np.float64)
    h, w = a.shape
    s = np.zeros((h + 1, w + 1), np.int64)
    sq = np.zeros((h + 1, w + 1), np.float64)
    s[1:, 1:] = np.cumsum(np.cumsum(a, 0), 1).astype(np.int64)
    sq[1:, 1:] = np.cumsum(np.cumsum(a * a, 0), 1)
    return s, sq


def integral3(src) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV ``integral3``: (sum, sqsum, tilted). The tilted (45°)
    sum follows cv2's definition (pinned by brute force in tests):
    ``tilted(Y, X) = Σ_{y<Y} Σ_{|x−(X−1)| ≤ Y−1−y} I(y, x)``."""
    s, sq = integral2(src)
    a = np.asarray(src, np.int64)
    h, w = a.shape
    # the diagonal-union recurrence T(Y,X) = T(Y-1,X-1) + T(Y-1,X+1)
    # − T(Y-2,X) + I(Y-1,X-1) + I(Y-2,X-1) holds on the INFINITE
    # zero-padded plane; run it on extended columns and slice
    off = h + 1
    ww = w + 1 + 2 * off
    t = np.zeros((h + 1, ww), np.int64)
    ax = np.zeros((h, ww), np.int64)
    ax[:, off + 1:off + 1 + w] = a  # I(y, x) at column off+1+x
    for yy in range(1, h + 1):
        row = (np.roll(t[yy - 1], 1) + np.roll(t[yy - 1], -1)
               - (t[yy - 2] if yy >= 2 else 0)
               + ax[yy - 1]
               + (ax[yy - 2] if yy >= 2 else 0))
        row[0] = row[-1] = 0
        t[yy] = row
    return s, sq, t[:, off:off + w + 1]


def threshold_with_mask(src, mask, thresh: float, maxval: float,
                        inv: bool = False):
    """OpenCV ``thresholdWithMask``: threshold only where mask≠0,
    pass source pixels through elsewhere."""
    if torch.is_tensor(src):
        above = src.to(torch.float32) > thresh
        if inv:
            above = ~above
        thr = torch.where(above, float(maxval), 0.0)
        m = torch.as_tensor(mask, device=src.device).to(torch.bool)
        return torch.where(m, thr, src.to(torch.float32)).to(src.dtype)
    above = src.astype(np.float64) > thresh
    if inv:
        above = ~above
    thr = np.where(above, maxval, 0)
    out = np.where(mask.astype(bool), thr, src)
    return out.astype(src.dtype)


def color_correction_matrix(src_colors, ref_colors,
                            affine: bool = True) -> np.ndarray:
    """Color-correction-matrix fit (OpenCV ``ccm`` module role): least
    squares M mapping measured patch colors onto reference colors in
    linear RGB — (3, 4) with offset when ``affine`` else (3, 3)."""
    s = np.asarray(src_colors, np.float64).reshape(-1, 3)
    r = np.asarray(ref_colors, np.float64).reshape(-1, 3)
    if affine:
        s = np.concatenate([s, np.ones((len(s), 1))], 1)
    m, *_ = np.linalg.lstsq(s, r, rcond=None)
    return m.T


def apply_ccm(img, ccm) -> np.ndarray:
    """Apply a (3, 3) or (3, 4) CCM to an (H, W, 3) image ([0,1] or
    u8 — u8 saturates back)."""
    m = np.asarray(ccm, np.float64)
    a = np.asarray(img)
    was_u8 = a.dtype == np.uint8
    x = a.astype(np.float64) / (255.0 if was_u8 else 1.0)
    flat = x.reshape(-1, 3)
    if m.shape[1] == 4:
        flat = np.concatenate([flat, np.ones((len(flat), 1))], 1)
    out = (flat @ m.T).reshape(a.shape)
    if was_u8:
        return np.clip(np.rint(out * 255.0), 0, 255).astype(np.uint8)
    return out


SOLVELP_SINGLE = 0
SOLVELP_MULTI = 1
SOLVELP_UNBOUNDED = -2
SOLVELP_UNFEASIBLE = -1


def solve_lp(func, constraints) -> Tuple[int, np.ndarray]:
    """OpenCV ``solveLP``: maximize cᵀx subject to A·x ≤ b, x ≥ 0
    (``constraints`` rows are [a..., b]) via the two-phase dense
    simplex with Bland's rule → (status, x). Status codes mirror
    cv2's: 0 single optimum, 1 multiple, −1 unfeasible, −2 unbounded."""
    c = np.asarray(func, np.float64).ravel()
    con = np.asarray(constraints, np.float64).reshape(-1, len(c) + 1)
    a = con[:, :-1]
    b = con[:, -1].copy()
    m, n = a.shape

    # standard form with slacks; phase 1 handles negative b rows
    # tableau: rows = constraints, cols = [x | slack | rhs]
    tab = np.zeros((m, n + m + 1))
    tab[:, :n] = a
    tab[:, n:n + m] = np.eye(m)
    tab[:, -1] = b
    basis = list(range(n, n + m))
    neg = b < 0
    if neg.any():
        # phase 1: add artificials for the negated rows
        art_rows = np.nonzero(neg)[0]
        tab[neg] = -tab[neg]
        n_art = len(art_rows)
        tab = np.concatenate(
            [tab[:, :-1], np.zeros((m, n_art)), tab[:, -1:]], axis=1)
        for i, r in enumerate(art_rows):
            tab[r, n + m + i] = 1.0
            basis[r] = n + m + i
        obj = np.zeros(tab.shape[1])
        for r in art_rows:
            obj -= tab[r]
        status = _simplex(tab, basis, obj)
        if status == SOLVELP_UNBOUNDED or -obj[-1] > 1e-9:
            return SOLVELP_UNFEASIBLE, np.zeros(n)
        tab = np.concatenate([tab[:, :n + m], tab[:, -1:]], axis=1)
        if any(v >= n + m for v in basis):
            return SOLVELP_UNFEASIBLE, np.zeros(n)

    obj = np.zeros(tab.shape[1])
    obj[:n] = c
    for i, bv in enumerate(basis):
        if obj[bv] != 0:
            obj = obj - obj[bv] * tab[i]
    status = _simplex(tab, basis, obj)
    if status == SOLVELP_UNBOUNDED:
        return SOLVELP_UNBOUNDED, np.zeros(n)
    x = np.zeros(n)
    for i, bv in enumerate(basis):
        if bv < n:
            x[bv] = tab[i, -1]
    # multiple optima: a non-basic structural/slack column with zero
    # reduced cost that could enter
    nonbasic = [j for j in range(tab.shape[1] - 1) if j not in basis]
    multi = any(abs(obj[j]) < 1e-9 and (tab[:, j] > 1e-9).any()
                for j in nonbasic)
    return (SOLVELP_MULTI if multi else SOLVELP_SINGLE), x


def _simplex(tab, basis, obj) -> int:
    """In-place simplex (maximization, Bland's rule); obj holds the
    negated reduced costs row (we maximize: enter while any > 0)."""
    for _ in range(2000):
        enter = -1
        for j in range(tab.shape[1] - 1):
            if obj[j] > 1e-9:
                enter = j
                break
        if enter < 0:
            return SOLVELP_SINGLE
        ratios = np.where(tab[:, enter] > 1e-9,
                          tab[:, -1] / np.where(tab[:, enter] > 1e-9,
                                                tab[:, enter], 1.0),
                          np.inf)
        leave = int(np.argmin(ratios))
        if not np.isfinite(ratios[leave]):
            return SOLVELP_UNBOUNDED
        piv = tab[leave, enter]
        tab[leave] /= piv
        for r in range(tab.shape[0]):
            if r != leave and abs(tab[r, enter]) > 1e-12:
                tab[r] -= tab[r, enter] * tab[leave]
        obj -= obj[enter] * tab[leave]
        basis[leave] = enter
    return SOLVELP_SINGLE


def border_interpolate(p: int, length: int,
                       border_type: str = "reflect101") -> int:
    """OpenCV ``borderInterpolate``: map an out-of-range coordinate to
    the in-range donor index under the border rule (constant → −1)."""
    if 0 <= p < length:
        return p
    if border_type == "constant":
        return -1
    if border_type == "replicate":
        return 0 if p < 0 else length - 1
    if border_type == "wrap":
        return p % length
    if border_type in ("reflect", "reflect101", "reflect_101",
                       "default"):
        refl = border_type == "reflect"  # mirror INCLUDING the edge
        # iterate the fold (cv2 does the same loop)
        while not (0 <= p < length):
            if p < 0:
                p = -p - 1 if refl else -p
            else:
                p = 2 * length - p - (1 if refl else 2)
        return p
    raise ValueError(f"unknown border_type {border_type!r}")


def rectangle_intersection_area(rect1, rect2) -> float:
    """OpenCV ``rectangleIntersectionArea`` for axis-aligned
    (x, y, w, h) float rects."""
    x1, y1, w1, h1 = (float(v) for v in rect1)
    x2, y2, w2, h2 = (float(v) for v in rect2)
    iw = min(x1 + w1, x2 + w2) - max(x1, x2)
    ih = min(y1 + h1, y2 + h2) - max(y1, y2)
    return max(iw, 0.0) * max(ih, 0.0)


def build_mst(num_nodes: int, edges
              ) -> Tuple[bool, np.ndarray]:
    """OpenCV ``buildMST`` role (Kruskal): edges are (src, dst, weight)
    rows; self-loops ignored, parallel edges keep the lightest,
    negative weights fine → (ok, (N-1, 3) MST edges ascending by
    weight). ok=False when the graph is disconnected or inputs are
    invalid."""
    e = np.asarray(edges, np.float64).reshape(-1, 3)
    n = int(num_nodes)
    if n <= 0:
        return False, np.zeros((0, 3))
    best = {}
    for s, d, w in e:
        si, di = int(s), int(d)
        if si == di:
            continue
        if not (0 <= si < n and 0 <= di < n):
            return False, np.zeros((0, 3))
        key = (min(si, di), max(si, di))
        if key not in best or w < best[key]:
            best[key] = w
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    out = []
    for (s, d), w in sorted(best.items(), key=lambda kv: kv[1]):
        ra, rb = find(s), find(d)
        if ra != rb:
            parent[ra] = rb
            out.append((s, d, w))
    if len(out) != n - 1:
        return False, np.zeros((0, 3))
    return True, np.asarray(sorted(out, key=lambda t: t[2]), np.float64)


def get_rect_sub_pix(img, patch_size, center):
    """OpenCV ``getRectSubPix``: bilinear sub-pixel patch extraction
    (replicate border) → u8 (h, w[, C])."""
    a = np.asarray(img)
    w, h = int(patch_size[0]), int(patch_size[1])
    cx, cy = float(center[0]), float(center[1])
    x0 = cx - (w - 1) / 2.0
    y0 = cy - (h - 1) / 2.0
    xs = x0 + np.arange(w)
    ys = y0 + np.arange(h)
    gx, gy = np.meshgrid(xs, ys)
    ih, iw = a.shape[:2]
    gx = np.clip(gx, 0, iw - 1.000001)
    gy = np.clip(gy, 0, ih - 1.000001)
    xi = np.floor(gx).astype(np.int64)
    yi = np.floor(gy).astype(np.int64)
    fx = gx - xi
    fy = gy - yi
    if a.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    out = (a[yi, xi] * (1 - fx) * (1 - fy)
           + a[yi, np.minimum(xi + 1, iw - 1)] * fx * (1 - fy)
           + a[np.minimum(yi + 1, ih - 1), xi] * (1 - fx) * fy
           + a[np.minimum(yi + 1, ih - 1),
               np.minimum(xi + 1, iw - 1)] * fx * fy)
    if a.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(a.dtype)


def check_range(m, min_val: float = -np.inf, max_val: float = np.inf
                ) -> Tuple[bool, Optional[Tuple[int, ...]]]:
    """OpenCV ``checkRange``: all elements finite and within
    [min_val, max_val) → (ok, position of the first bad element)."""
    a = np.asarray(m, np.float64)
    bad = ~np.isfinite(a) | (a < min_val) | (a >= max_val)
    if not bad.any():
        return True, None
    pos = np.unravel_index(int(np.argmax(bad)), a.shape)
    return False, tuple(int(v) for v in pos)
