"""Copy of ``rustcv_tpu.ops.qr`` (the port's ``warp``). QR code generation, detection, and decoding (OpenCV
``QRCodeDetector`` role: detect / decode / detectAndDecode).

Scope (frozen): model-2 QR versions 1–4, byte mode, all four ECC
levels, all eight masks. The encoder exists so detection tests are
self-consistent end-to-end (like the ArUco module: no external data —
every table below is computed from the QR spec's published generator
polynomials and BCH codes, not copied from another implementation).

Pipeline (host orchestration over this framework's primitives):
- finder patterns: classic 1:1:3:1:1 run-ratio scan over rows and
  columns, centers clustered and cross-checked;
- geometry: the corner finder is the one seeing the other two at ~90°;
  version from finder spacing; sampling homography from the three
  finder centers + the extrapolated fourth corner
  (ops/warp.get_perspective_transform);
- decode: format info (BCH(15,5), masked with 0x5412) → ECC level +
  mask; unmask; codewords in the spec's zigzag order; Reed-Solomon
  error correction over GF(256) (syndromes → Berlekamp-Massey → Chien
  → GF Gaussian magnitude solve); byte-mode payload parse.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import warp

# ---------------------------------------------------------------------------
# GF(256) arithmetic (QR polynomial x^8 + x^4 + x^3 + x^2 + 1 = 0x11d)
# ---------------------------------------------------------------------------

_EXP = np.zeros(512, np.int32)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _gf_div(a: int, b: int) -> int:
    if a == 0:
        return 0
    return int(_EXP[(_LOG[a] - _LOG[b]) % 255])


def _poly_mul(p: List[int], q: List[int]) -> List[int]:
    out = [0] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            out[i + j] ^= _gf_mul(a, b)
    return out


def _rs_generator(n: int) -> List[int]:
    g = [1]
    for i in range(n):
        g = _poly_mul(g, [1, int(_EXP[i])])
    return g


def rs_encode(data: List[int], n_ecc: int) -> List[int]:
    """→ ECC codewords appended to ``data`` (systematic RS)."""
    gen = _rs_generator(n_ecc)
    rem = list(data) + [0] * n_ecc
    for i in range(len(data)):
        coef = rem[i]
        if coef:
            for j in range(1, len(gen)):
                rem[i + j] ^= _gf_mul(gen[j], coef)
    return list(data) + rem[len(data):]


def _poly_eval(p_desc: List[int], x: int) -> int:
    """Evaluate polynomial (descending coefficients) at x."""
    acc = 0
    for c in p_desc:
        acc = _gf_mul(acc, x) ^ c
    return acc


def rs_correct(codeword: List[int], n_ecc: int) -> Optional[List[int]]:
    """Correct up to ``n_ecc // 2`` errors → fixed codeword, or None.

    Berlekamp-Massey for the error locator, Chien search for the
    positions, then the syndrome system ``S_j = Σ_l e_l · X_l^j`` is
    solved directly by Gaussian elimination over GF(256) (t ≤ 14 here —
    a t×t solve is simpler to keep right than Forney's formal
    derivative bookkeeping, and the final syndrome re-check guards it).
    """
    n = len(codeword)
    synd = [_poly_eval(codeword, int(_EXP[j])) for j in range(n_ecc)]
    if max(synd) == 0:
        return list(codeword)

    def poly_add(p, q):
        r = [0] * max(len(p), len(q))
        for i, v in enumerate(p):
            r[i + len(r) - len(p)] = v
        for i, v in enumerate(q):
            r[i + len(r) - len(q)] ^= v
        return r

    # Berlekamp-Massey (descending-coefficient locator, constant last)
    err_loc = [1]
    old_loc = [1]
    for i in range(n_ecc):
        delta = synd[i]
        for j in range(1, len(err_loc)):
            delta ^= _gf_mul(err_loc[-(j + 1)], synd[i - j])
        old_loc = old_loc + [0]
        if delta:
            if len(old_loc) > len(err_loc):
                new_loc = [_gf_mul(x, delta) for x in old_loc]
                old_loc = [_gf_div(x, delta) for x in err_loc]
                err_loc = new_loc
            err_loc = poly_add(err_loc,
                               [_gf_mul(x, delta) for x in old_loc])
    while len(err_loc) > 1 and err_loc[0] == 0:
        err_loc = err_loc[1:]
    n_err = len(err_loc) - 1
    if n_err == 0 or n_err * 2 > n_ecc:
        return None

    # Chien search: Λ's roots sit at X_l^{-1} = α^{-p} for an error at
    # power p = n-1-idx, so test α^{(255-p) mod 255} per codeword index
    positions = []
    for idx in range(n):
        p = n - 1 - idx
        if _poly_eval(err_loc, int(_EXP[(255 - p) % 255])) == 0:
            positions.append(idx)
    if len(positions) != n_err:
        return None

    # magnitudes: solve S_j = Σ_l e_l · X_l^j, X_l = α^(n-1-pos_l)
    xs = [int(_EXP[(n - 1 - p) % 255]) for p in positions]
    t = n_err
    a = [[0] * (t + 1) for _ in range(t)]
    for j in range(t):
        for l in range(t):
            a[j][l] = int(_EXP[(_LOG[xs[l]] * j) % 255])
        a[j][t] = synd[j]
    # Gaussian elimination over GF(256)
    for col in range(t):
        piv = next((r for r in range(col, t) if a[r][col]), None)
        if piv is None:
            return None
        a[col], a[piv] = a[piv], a[col]
        inv = _gf_div(1, a[col][col])
        a[col] = [_gf_mul(v, inv) for v in a[col]]
        for r in range(t):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [v ^ _gf_mul(f, w) for v, w in zip(a[r], a[col])]
    out = list(codeword)
    for l, p in enumerate(positions):
        out[p] ^= a[l][t]
    for j in range(n_ecc):
        if _poly_eval(out, int(_EXP[j])) != 0:
            return None
    return out


# ---------------------------------------------------------------------------
# QR tables (computed per spec, versions 1-4)
# ---------------------------------------------------------------------------

# (total codewords, per-level (ecc_per_block, n_blocks)) — spec table
_VERSION_INFO = {
    1: (26, {"L": (7, 1), "M": (10, 1), "Q": (13, 1), "H": (17, 1)}),
    2: (44, {"L": (10, 1), "M": (16, 1), "Q": (22, 1), "H": (28, 1)}),
    3: (70, {"L": (15, 1), "M": (26, 1), "Q": (18, 2), "H": (22, 2)}),
    4: (100, {"L": (20, 1), "M": (18, 2), "Q": (26, 2), "H": (16, 4)}),
}
_ALIGN_POS = {1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26]}
_LEVEL_BITS = {"L": 1, "M": 0, "Q": 3, "H": 2}
_BITS_LEVEL = {v: k for k, v in _LEVEL_BITS.items()}


def _bch_format(level: str, mask: int) -> int:
    """15-bit format string: 5 data bits + BCH(15,5) ecc, XOR 0x5412."""
    data = (_LEVEL_BITS[level] << 3) | mask
    d = data << 10
    g = 0b10100110111
    for i in range(14, 9, -1):
        if d & (1 << i):
            d ^= g << (i - 10)
    return ((data << 10) | d) ^ 0x5412


_FORMATS = {(_BITS_LEVEL[b], m): _bch_format(_BITS_LEVEL[b], m)
            for b in _BITS_LEVEL for m in range(8)}


def _mask_fn(mask: int):
    return [
        lambda r, c: (r + c) % 2 == 0,
        lambda r, c: r % 2 == 0,
        lambda r, c: c % 3 == 0,
        lambda r, c: (r + c) % 3 == 0,
        lambda r, c: (r // 2 + c // 3) % 2 == 0,
        lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
        lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
        lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
    ][mask]


def _function_mask(version: int) -> np.ndarray:
    """True where modules are function patterns (not data)."""
    n = 17 + 4 * version
    f = np.zeros((n, n), bool)
    for (r0, c0) in ((0, 0), (0, n - 7), (n - 7, 0)):
        f[max(r0 - 1, 0):r0 + 8, max(c0 - 1, 0):c0 + 8] = True
    f[6, :] = True
    f[:, 6] = True
    # format info areas
    f[8, :9] = True
    f[:9, 8] = True
    f[8, n - 8:] = True
    f[n - 8:, 8] = True
    for cy in _ALIGN_POS[version]:
        for cx in _ALIGN_POS[version]:
            # skip alignment overlapping finders
            if (cy < 9 and cx < 9) or (cy < 9 and cx > n - 10) \
                    or (cy > n - 10 and cx < 9):
                continue
            f[cy - 2:cy + 3, cx - 2:cx + 3] = True
    return f


def _base_matrix(version: int) -> np.ndarray:
    """Function-pattern modules (True = dark), data area False."""
    n = 17 + 4 * version
    m = np.zeros((n, n), bool)

    def finder(r0, c0):
        m[r0:r0 + 7, c0:c0 + 7] = True
        m[r0 + 1:r0 + 6, c0 + 1:c0 + 6] = False
        m[r0 + 2:r0 + 5, c0 + 2:c0 + 5] = True

    finder(0, 0)
    finder(0, n - 7)
    finder(n - 7, 0)
    for i in range(8, n - 8):
        m[6, i] = i % 2 == 0
        m[i, 6] = i % 2 == 0
    for cy in _ALIGN_POS[version]:
        for cx in _ALIGN_POS[version]:
            if (cy < 9 and cx < 9) or (cy < 9 and cx > n - 10) \
                    or (cy > n - 10 and cx < 9):
                continue
            m[cy - 2:cy + 3, cx - 2:cx + 3] = True
            m[cy - 1:cy + 2, cx - 1:cx + 2] = False
            m[cy, cx] = True
    m[n - 8, 8] = True          # dark module
    return m


def _data_coords(version: int) -> List[Tuple[int, int]]:
    """Module (row, col) placement order for data bits (spec zigzag)."""
    n = 17 + 4 * version
    func = _function_mask(version)
    coords = []
    col = n - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rows = range(n - 1, -1, -1) if upward else range(n)
        for r in rows:
            for c in (col, col - 1):
                if not func[r, c]:
                    coords.append((r, c))
        upward = not upward
        col -= 2
    return coords


def _interleave(blocks: List[List[int]], ecc_blocks: List[List[int]]):
    out = []
    for i in range(max(len(b) for b in blocks)):
        for b in blocks:
            if i < len(b):
                out.append(b[i])
    for i in range(len(ecc_blocks[0])):
        for b in ecc_blocks:
            out.append(b[i])
    return out


def encode(text: str, version: int = 1, level: str = "L",
           mask: int = 0) -> np.ndarray:
    """Byte-mode QR → bool matrix (True = dark module)."""
    total, table = _VERSION_INFO[version]
    ecc_per_block, n_blocks = table[level]
    n_data = total - ecc_per_block * n_blocks
    payload = text.encode("utf-8")
    cap_bits = n_data * 8 - 4 - 8
    if len(payload) * 8 > cap_bits:
        raise ValueError(f"text too long for version {version}-{level}")
    bits = []

    def put(v, nb):
        for i in range(nb - 1, -1, -1):
            bits.append((v >> i) & 1)

    put(0b0100, 4)
    put(len(payload), 8)
    for byte in payload:
        put(byte, 8)
    put(0, min(4, n_data * 8 - len(bits)))
    while len(bits) % 8:
        bits.append(0)
    pad = [0xEC, 0x11]
    k = 0
    data = [int("".join(map(str, bits[i:i + 8])), 2)
            for i in range(0, len(bits), 8)]
    while len(data) < n_data:
        data.append(pad[k % 2])
        k += 1
    # split into blocks (versions 1-4: equal-size blocks suffice for
    # the level/version pairs in _VERSION_INFO)
    per = n_data // n_blocks
    blocks = [data[i * per:(i + 1) * per] for i in range(n_blocks)]
    eccs = [rs_encode(b, ecc_per_block)[len(b):] for b in blocks]
    stream = _interleave(blocks, eccs)

    m = _base_matrix(version)
    coords = _data_coords(version)
    mf = _mask_fn(mask)
    bitstream = []
    for cw in stream:
        for i in range(7, -1, -1):
            bitstream.append((cw >> i) & 1)
    bitstream += [0] * (len(coords) - len(bitstream))
    for (r, c), b in zip(coords, bitstream):
        m[r, c] = bool(b) ^ mf(r, c)
    # format info
    fmt = _FORMATS[(level, mask)]
    fbits = [(fmt >> (14 - i)) & 1 for i in range(15)]
    n = m.shape[0]
    pos_a = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7),
             (8, 8), (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8),
             (0, 8)]
    pos_b = [(n - 1, 8), (n - 2, 8), (n - 3, 8), (n - 4, 8), (n - 5, 8),
             (n - 6, 8), (n - 7, 8), (8, n - 8), (8, n - 7), (8, n - 6),
             (8, n - 5), (8, n - 4), (8, n - 3), (8, n - 2), (8, n - 1)]
    for (r, c), b in zip(pos_a, fbits):
        m[r, c] = bool(b)
    for (r, c), b in zip(pos_b, fbits):
        m[r, c] = bool(b)
    return m


def draw(matrix: np.ndarray, cell_px: int = 4, quiet: int = 4, *,
         module_px: int = None, border: int = None) -> np.ndarray:
    """bool matrix → u8 image (dark = 0) with a quiet zone.

    ``module_px``/``border`` are accepted as aliases for
    ``cell_px``/``quiet`` (qrcode-library naming)."""
    if module_px is not None:
        cell_px = int(module_px)
    if border is not None:
        quiet = int(border)
    n = matrix.shape[0]
    canvas = np.ones((n + 2 * quiet, n + 2 * quiet), bool)
    canvas[quiet:quiet + n, quiet:quiet + n] = ~matrix
    return (np.repeat(np.repeat(canvas, cell_px, 0), cell_px, 1)
            .astype(np.uint8) * 255)


# ---------------------------------------------------------------------------
# decoding from a sampled module matrix
# ---------------------------------------------------------------------------

def decode_matrix(m: np.ndarray) -> Optional[str]:
    """bool module matrix (True = dark) → text, or None."""
    n = m.shape[0]
    version = (n - 17) // 4
    if version not in _VERSION_INFO or 17 + 4 * version != n:
        return None
    # read format info (copy A), match against all 32 valid formats
    pos_a = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7),
             (8, 8), (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8),
             (0, 8)]
    fval = 0
    for (r, c) in pos_a:
        fval = (fval << 1) | int(m[r, c])
    best = None
    for (level, mask), fmt in _FORMATS.items():
        d = bin(fval ^ fmt).count("1")
        if best is None or d < best[0]:
            best = (d, level, mask)
    if best[0] > 3:
        return None
    _, level, mask = best
    total, table = _VERSION_INFO[version]
    ecc_per_block, n_blocks = table[level]
    n_data = total - ecc_per_block * n_blocks

    coords = _data_coords(version)
    mf = _mask_fn(mask)
    bits = [int(m[r, c]) ^ int(mf(r, c)) for (r, c) in coords]
    stream = [int("".join(map(str, bits[i:i + 8])), 2)
              for i in range(0, len(bits) - 7, 8)][:total]
    # de-interleave
    per = n_data // n_blocks
    blocks = [[] for _ in range(n_blocks)]
    i = 0
    for j in range(per):
        for b in range(n_blocks):
            blocks[b].append(stream[i])
            i += 1
    eccs = [[] for _ in range(n_blocks)]
    for j in range(ecc_per_block):
        for b in range(n_blocks):
            eccs[b].append(stream[i])
            i += 1
    data = []
    for b in range(n_blocks):
        fixed = rs_correct(blocks[b] + eccs[b], ecc_per_block)
        if fixed is None:
            return None
        data.extend(fixed[:per])
    # parse byte mode
    bitstr = []
    for cw in data:
        for i in range(7, -1, -1):
            bitstr.append((cw >> i) & 1)

    def take(nb):
        nonlocal bitstr
        v = 0
        for _ in range(nb):
            v = (v << 1) | bitstr.pop(0)
        return v

    mode = take(4)
    if mode != 0b0100:
        return None
    count = take(8)
    if count * 8 > len(bitstr):
        return None
    try:
        return bytes(take(8) for _ in range(count)).decode("utf-8")
    except UnicodeDecodeError:
        return None


# ---------------------------------------------------------------------------
# image-level detection
# ---------------------------------------------------------------------------

def _runs(vals):
    out = []
    start = 0
    cur = vals[0]
    for i in range(1, len(vals)):
        if vals[i] != cur:
            out.append((cur, start, i - start))
            cur = vals[i]
            start = i
    out.append((cur, start, len(vals) - start))
    return out


def _ratio_windows(vals):
    """1:1:3:1:1 dark-led windows in a binary line → [(center, unit)]."""
    hits = []
    runs = _runs(vals)
    for i in range(len(runs) - 4):
        window = runs[i:i + 5]
        if window[0][0] != 1:
            continue
        sizes = [r[2] for r in window]
        unit = sum(sizes) / 7.0
        if unit < 1.0:
            continue
        if all(abs(s - e * unit) <= max(unit * 0.6, 1.5)
               for s, e in zip(sizes, (1, 1, 3, 1, 1))):
            hits.append((window[0][1] + sum(sizes) / 2.0, unit))
    return hits


def _finder_centers(dark: np.ndarray) -> np.ndarray:
    """Finder-pattern centers [K, 2] (x, y): row-scan candidates
    cross-checked by a column scan through the candidate (the classic
    two-axis 1:1:3:1:1 verification), clustered."""
    h, w = dark.shape
    row_hits = []                     # (xc, y, unit)
    for y in range(h):
        for xc, unit in _ratio_windows(dark[y].astype(int)):
            row_hits.append((xc, float(y), unit))
    centers = []
    for xc, y, unit in row_hits:
        col = dark[:, int(round(xc))].astype(int)
        ok = None
        for yc, vunit in _ratio_windows(col):
            if abs(yc - y) <= 2.0 * unit                     and 0.4 < vunit / unit < 2.5:
                ok = (xc, yc)
                break
        if ok is None:
            continue
        merged = False
        for c in centers:
            if abs(c[0] - ok[0]) < 3 * unit and abs(c[1] - ok[1]) < 3 * unit:
                c[0] = 0.5 * (c[0] + ok[0])
                c[1] = 0.5 * (c[1] + ok[1])
                c[2] += 1
                merged = True
                break
        if not merged:
            centers.append([ok[0], ok[1], 1])
    good = [(c[0], c[1]) for c in centers if c[2] >= 3]
    return np.asarray(good) if good else np.zeros((0, 2))


def detect_and_decode(img: np.ndarray,
                      thresh: Optional[float] = None):
    """u8 gray → (text or None, corners float32 [4, 2] or None)
    (OpenCV ``QRCodeDetector.detectAndDecode`` role). Modules should
    span ≥ 4 px — the 3×3 denoising pre-smooth erodes thinner runs."""
    g = np.asarray(img)
    if g.ndim == 3:
        g = g[..., 0]
    # 3x3 box pre-smoothing: the run-ratio scan needs clean runs
    gp = np.pad(g.astype(np.int32), 1, mode="edge")
    gs = sum(gp[dy:dy + g.shape[0], dx:dx + g.shape[1]]
             for dy in range(3) for dx in range(3)) // 9
    t = float(gs.mean()) if thresh is None else float(thresh)
    dark = gs < t
    centers = _finder_centers(dark)
    if len(centers) < 3 or len(centers) > 8:
        return None, None
    # choose the 3-subset forming the best right isoceles triangle
    # (spurious ratio hits can add extra candidates under noise)
    from itertools import combinations

    best = None
    for tri in combinations(range(len(centers)), 3):
        for ci in tri:
            a, b = [centers[j] for j in tri if j != ci]
            v1 = a - centers[ci]
            v2 = b - centers[ci]
            l1 = np.linalg.norm(v1)
            l2 = np.linalg.norm(v2)
            if min(l1, l2) < 8:
                continue
            cosang = abs(v1 @ v2) / (l1 * l2)
            skew = abs(l1 - l2) / max(l1, l2)
            score = cosang + skew
            if best is None or score < best[0]:
                best = (score, ci, tri)
    if best is None or best[0] > 0.35:
        return None, None
    _, ci, tri = best
    corner = centers[ci]
    others = [centers[j] for j in tri if j != ci]
    # order others so (o1 - corner) x (o2 - corner) > 0 (y-down CW:
    # o1 = top-right, o2 = bottom-left for a canonical code)
    v1 = others[0] - corner
    v2 = others[1] - corner
    if v1[0] * v2[1] - v1[1] * v2[0] < 0:
        others = [others[1], others[0]]
    o1, o2 = others
    # version from module pitch: finder centers are 3.5 modules in from
    # the corners; center distance = (n - 7) modules
    dist = 0.5 * (np.linalg.norm(o1 - corner) + np.linalg.norm(o2 - corner))
    for version in (1, 2, 3, 4):
        n = 17 + 4 * version
        pitch = dist / (n - 7)
        # sample homography: finder centers at module coords (3.5, 3.5),
        # (n-3.5, 3.5), (3.5, n-3.5); fourth = extrapolated corner
        src = np.array([[3.5, 3.5], [n - 3.5, 3.5], [3.5, n - 3.5],
                        [n - 3.5, n - 3.5]])
        fourth = o1 + o2 - corner
        dst = np.array([corner, o1, o2, fourth])
        hmat = warp.get_perspective_transform(src, dst)
        ys, xs = np.mgrid[0:n, 0:n].astype(np.float64) + 0.5
        pts = np.stack([xs.ravel(), ys.ravel(),
                        np.ones(n * n)], axis=1) @ hmat.T
        px = pts[:, 0] / pts[:, 2]
        py = pts[:, 1] / pts[:, 2]
        ix = np.clip(np.round(px).astype(int), 0, g.shape[1] - 1)
        iy = np.clip(np.round(py).astype(int), 0, g.shape[0] - 1)
        mm = dark[iy, ix].reshape(n, n)
        for candidate in (mm, mm.T):     # .T = mirrored pickup
            text = decode_matrix(candidate)
            if text is not None:
                quad = np.stack([corner, o1, fourth, o2]).astype(
                    np.float32)
                return text, quad
    return None, None
