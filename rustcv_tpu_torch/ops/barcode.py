"""EAN-13 / UPC-A barcodes (OpenCV ``barcode::BarcodeDetector`` role):
spec-derived encoder + scanline decoder.

Frozen spec (the public EAN-13 standard — all tables are generated
from the standard's L-code digit patterns, no data copied from any
implementation):
- symbology: 95 modules = guard 101 + 6 left digits (7 modules each,
  L/G parity selected by the implicit 13th digit) + center 01010 +
  6 right digits (R = bitwise NOT of L) + guard 101;
- check digit: (10 − Σ odd + 3·Σ even mod 10) mod 10 over the first
  12 digits;
- decoding: adaptive-threshold a scanline to runs, fit the 59-run
  EAN structure anywhere in the line (both directions), classify each
  digit by nearest run-length pattern in L/G/R, recover the first
  digit from the left-half parity word, verify the checksum;
- detection: scan rows at a fixed stride and majority-vote the decoded
  strings (rotation handled by also scanning columns).

tests/test_barcode.py round-trips ours and cross-decodes against
cv2.barcode_BarcodeDetector in both directions.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# L-codes from the EAN standard: number of modules per bar, encoded as
# the 4 run lengths (space, bar, space, bar) summing to 7
_L_RUNS = {
    0: (3, 2, 1, 1), 1: (2, 2, 2, 1), 2: (2, 1, 2, 2),
    3: (1, 4, 1, 1), 4: (1, 1, 3, 2), 5: (1, 2, 3, 1),
    6: (1, 1, 1, 4), 7: (1, 3, 1, 2), 8: (1, 2, 1, 3),
    9: (3, 1, 1, 2),
}
# first-digit → left-half parity pattern (L=0, G=1)
_PARITY = {
    0: (0, 0, 0, 0, 0, 0), 1: (0, 0, 1, 0, 1, 1),
    2: (0, 0, 1, 1, 0, 1), 3: (0, 0, 1, 1, 1, 0),
    4: (0, 1, 0, 0, 1, 1), 5: (0, 1, 1, 0, 0, 1),
    6: (0, 1, 1, 1, 0, 0), 7: (0, 1, 0, 1, 0, 1),
    8: (0, 1, 0, 1, 1, 0), 9: (0, 1, 1, 0, 1, 0),
}


def _l_bits(d: int) -> List[int]:
    bits = []
    v = 0
    for run in _L_RUNS[d]:
        bits.extend([v] * run)
        v ^= 1
    return bits  # starts with spaces (0), ends with bar (1)


def ean13_checksum(digits12) -> int:
    d = [int(v) for v in digits12]
    s = sum(d[0::2]) + 3 * sum(d[1::2])
    return (10 - s % 10) % 10


def encode_ean13(digits12) -> np.ndarray:
    """12 digits → 95-module bit pattern (1 = bar/dark)."""
    d = [int(v) for v in str(digits12)] if isinstance(digits12, str) \
        else [int(v) for v in digits12]
    if len(d) == 13:
        if d[12] != ean13_checksum(d[:12]):
            raise ValueError("bad check digit")
        d = d[:12]
    if len(d) != 12:
        raise ValueError("EAN-13 needs 12 digits (+optional check)")
    check = ean13_checksum(d)
    full = d + [check]
    first, left, right = full[0], full[1:7], full[7:]
    bits = [1, 0, 1]
    parity = _PARITY[first]
    for i, digit in enumerate(left):
        lb = _l_bits(digit)
        if parity[i]:  # G code = NOT(reverse(L)) — space-first kept
            lb = [1 - b for b in lb[::-1]]
        bits.extend(lb)
    bits.extend([0, 1, 0, 1, 0])
    for digit in right:
        bits.extend(1 - b for b in _l_bits(digit))  # R = NOT L
    bits.extend([1, 0, 1])
    return np.asarray(bits, np.uint8)


def draw_barcode(bits: np.ndarray, module_px: int = 3,
                 height: int = 60, quiet: int = 9) -> np.ndarray:
    """→ u8 image (white background, black bars, quiet zones)."""
    row = np.repeat(1 - np.asarray(bits, np.uint8), module_px) * 255
    row = np.concatenate([np.full(quiet * module_px, 255, np.uint8),
                          row,
                          np.full(quiet * module_px, 255, np.uint8)])
    return np.tile(row, (height, 1))


def _runs_of(binary: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    change = np.nonzero(np.diff(binary.astype(np.int8)))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(binary)]])
    return (ends - starts).astype(np.float64), binary[starts]


_DIGIT_TABLES = None


def _tables():
    global _DIGIT_TABLES
    if _DIGIT_TABLES is None:
        l_tab = {d: np.asarray(r, np.float64) for d, r in _L_RUNS.items()}
        g_tab = {d: v[::-1].copy() for d, v in l_tab.items()}
        _DIGIT_TABLES = (l_tab, g_tab)
    return _DIGIT_TABLES


def _classify(runs4: np.ndarray, table) -> Tuple[int, float]:
    scaled = runs4 / runs4.sum() * 7.0
    best, best_err = -1, np.inf
    for d, pat in table.items():
        err = np.abs(scaled - pat).max()
        if err < best_err:
            best, best_err = d, err
    return best, best_err


def decode_ean13_scanline(line: np.ndarray) -> Optional[str]:
    """One gray scanline → 13-digit string or None (tries both
    directions and every guard alignment)."""
    g = np.asarray(line, np.float64)
    if g.max() - g.min() < 30:
        return None
    thr = (g.max() + g.min()) / 2.0
    dark = (g < thr).astype(np.uint8)
    for d in (dark, dark[::-1]):
        out = _decode_runs(*_runs_of(d))
        if out is not None:
            return out
    return None


def _decode_runs(lens: np.ndarray, first_vals: np.ndarray
                 ) -> Optional[str]:
    # the 59-run payload starts at a dark run: guard(3) + 24 + 5 + 24 + 3
    n = len(lens)
    vals = first_vals
    for s in range(n - 58):
        if vals[s] != 1:
            continue
        seg = lens[s:s + 59]
        module = (seg[0] + seg[1] + seg[2]) / 3.0
        if not (0.5 <= module):
            continue
        # guards: 101 (1,1,1), center 01010, end 101
        if np.abs(seg[:3] / module - 1).max() > 0.5:
            continue
        if np.abs(seg[27:32] / module - 1).max() > 0.6:
            continue
        if np.abs(seg[56:59] / module - 1).max() > 0.5:
            continue
        l_tab, g_tab = _tables()
        left_digits = []
        parity = []
        ok = True
        for i in range(6):
            runs4 = seg[3 + 4 * i: 7 + 4 * i]
            dl, el = _classify(runs4, l_tab)
            dg, eg = _classify(runs4, g_tab)
            if min(el, eg) > 0.8:
                ok = False
                break
            if el <= eg:
                left_digits.append(dl)
                parity.append(0)
            else:
                left_digits.append(dg)
                parity.append(1)
        if not ok:
            continue
        first = next((k for k, v in _PARITY.items()
                      if v == tuple(parity)), None)
        if first is None:
            continue
        right_digits = []
        for i in range(6):
            runs4 = seg[32 + 4 * i: 36 + 4 * i]
            # R codes have the same run lengths as L (bit-inverted
            # pattern, runs starting on a bar)
            dr, er = _classify(runs4, l_tab)
            if er > 0.8:
                ok = False
                break
            right_digits.append(dr)
        if not ok:
            continue
        digits = [first] + left_digits + right_digits
        if digits[12] != ean13_checksum(digits[:12]):
            continue
        return "".join(str(v) for v in digits)
    return None


def detect_and_decode(img: np.ndarray, stride: int = 4
                      ) -> List[str]:
    """Scan rows then columns at ``stride``, majority-vote decodes →
    unique list (most frequent first)."""
    g = np.asarray(img)
    if g.ndim == 3:
        g = g.mean(axis=-1)
    votes = {}
    for axis_img in (g, g.T):
        for y in range(0, axis_img.shape[0], stride):
            out = decode_ean13_scanline(axis_img[y])
            if out:
                votes[out] = votes.get(out, 0) + 1
    return [k for k, _ in sorted(votes.items(), key=lambda kv: -kv[1])]
