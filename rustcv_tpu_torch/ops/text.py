"""Text rasterization for put_text without Pillow (port of
``rustcv_tpu.ops.text``).

The reference renders with Pillow: FreeType's hinted outlines, laid out by
raqm (HarfBuzz), rasterized by FreeType's smooth renderer and composed
glyph over glyph. Its masks are the spec (``tests/test_spec_freeze.py``
pins three by hash). The port reproduces them from its own data and code:

* ``assets/dejavusans_text.npz`` holds, per pixel size 1-160, the
  vendored DejaVuSans' hinted outlines of every glyph that printable ASCII
  and Latin-1 (U+00A0-U+00FF) shape to, HarfBuzz's advances and pair
  kerning, the ligature rules and the ascent/descent (written by
  ``tools/make_text_data.py``, which runs only where Pillow with raqm is
  present);
* the layout is Pillow's: pen positions in 26.6, each glyph drawn at its
  pen rounded to whole pixels (``(x + 32) >> 6``), the text box from the
  pixel control boxes at those positions and the pen line, glyphs clipped
  to that box. The soft hyphen (U+00AD) is default-ignorable: the text is
  shaped without it (ligatures and kerning reach across it) and it comes
  back as the space glyph with no advance, after the glyph that holds the
  character before it, as HarfBuzz places it;
* ``native/text_raster.cpp`` rasterizes each outline and composes it over
  the canvas as Pillow does.

A size outside the data (``round(font_scale * 20)`` above 160) or a
character outside printable ASCII and Latin-1 (a control character such as
``\n`` or ``\t``, another script) raises ``not_ported``: nothing is
approximated. Masks are padded to bucketed widths (as the reference's), so
changing strings keep a few stable shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..core.errors import not_ported

DATA = Path(__file__).resolve().parents[1] / "assets" / "dejavusans_text.npz"
FIRST_CHAR, LAST_CHAR = 0x20, 0xFF  # the cmap's range; its -1s (0x7F-0x9F) are not in the data
SOFT_HYPHEN = "\xad"

# Canvas width buckets, the reference's.
_WIDTH_BUCKETS = (64, 128, 256, 512, 1024)


def _bucket(n: int, buckets=_WIDTH_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def _pixel(x: int) -> int:
    """26.6 → whole pixels, rounded as Pillow rounds a pen position."""
    return (x + 32) >> 6


@dataclass(frozen=True)
class _Size:
    """One pixel size's tables: outlines as int32 points, on-curve flags and
    contour ends per glyph; the pixel control box of each glyph."""

    ascent: int
    descent: int
    advance: np.ndarray  # int64 [G], 26.6
    kern: Dict[Tuple[int, int], int]
    points: List[np.ndarray]  # int32 [P, 2] per glyph
    on_curve: List[np.ndarray]  # uint8 [P]
    ends: List[np.ndarray]  # int32 [C]
    cbox: np.ndarray  # int64 [G, 4]: x0, y0, x1, y1 in pixels (0s when empty)


class _FontData:
    def __init__(self, path: Path = DATA):
        with np.load(path) as z:
            d = {k: z[k] for k in z.files}
        self.sizes = [int(s) for s in d["sizes"]]
        self.cmap = d["cmap"].astype(np.int64)
        self.ligatures = [(str(t), int(g)) for t, g in zip(d["lig_text"], d["lig_out"])]
        self._d = d
        n_pts = d["n_points"].astype(np.int64).ravel()
        n_ctr = d["n_contours"].astype(np.int64).ravel()
        self._pt_start = np.concatenate([[0], np.cumsum(n_pts)])
        self._ct_start = np.concatenate([[0], np.cumsum(n_ctr)])
        self._kern_pairs = [tuple(map(int, p)) for p in d["kern_pairs"]]
        self._cache: Dict[int, _Size] = {}

    @property
    def n_glyphs(self) -> int:
        return self._d["advance"].shape[1]

    def size(self, px: int) -> _Size:
        got = self._cache.get(px)
        if got is not None:
            return got
        d, si, g_n = self._d, self.sizes.index(px), self.n_glyphs
        on_all = np.unpackbits(d["on_curve"])
        points, on_curve, ends, cbox = [], [], [], np.zeros((g_n, 4), np.int64)
        for g in range(g_n):
            k = si * g_n + g
            a, b = self._pt_start[k], self._pt_start[k + 1]
            xy = np.cumsum(d["point_deltas"][a:b].astype(np.int64), axis=0).astype(np.int32)
            points.append(np.ascontiguousarray(xy))
            on_curve.append(np.ascontiguousarray(on_all[a:b], np.uint8))
            c0, c1 = self._ct_start[k], self._ct_start[k + 1]
            ends.append(np.ascontiguousarray(d["contour_ends"][c0:c1], np.int32))
            if len(xy):
                lo, hi = xy.min(axis=0).astype(np.int64), xy.max(axis=0).astype(np.int64)
                cbox[g] = (lo[0] >> 6, lo[1] >> 6, -((-hi[0]) >> 6), -((-hi[1]) >> 6))
        kern = {p: int(v) for p, v in zip(self._kern_pairs, d["kern"][si]) if v}
        got = _Size(int(d["metrics"][si, 0]), int(d["metrics"][si, 1]),
                    d["advance"][si].astype(np.int64), kern, points, on_curve, ends, cbox)
        self._cache[px] = got
        return got

    def glyphs(self, text: str) -> List[int]:
        """Glyph indices of ``text``: soft hyphens set aside, ligatures
        first, longest rule first; each soft hyphen back as the space glyph
        after the glyph that holds the character before it."""
        plain = text.replace(SOFT_HYPHEN, "")
        runs, i = [], 0  # (glyph, characters it takes)
        while i < len(plain):
            for lig, g in self.ligatures:
                if plain.startswith(lig, i):
                    runs.append((g, len(lig)))
                    break
            else:
                runs.append((int(self.cmap[ord(plain[i]) - FIRST_CHAR]), 1))
            i += runs[-1][1]
        if len(plain) == len(text):
            return [g for g, _ in runs]
        out, k, start, seen = [], 0, 0, 0
        for c in text:
            if c != SOFT_HYPHEN:
                seen += 1
                continue
            while k < len(runs) and start < seen:
                out.append(runs[k][0])
                start += runs[k][1]
                k += 1
            out.append(-1)  # the soft hyphen's place
        return out + [g for g, _ in runs[k:]]


@lru_cache(maxsize=1)
def _data() -> _FontData:
    return _FontData()


def _px_size(font_scale: float) -> int:
    px = max(1, round(font_scale * 20.0))
    sizes = _data().sizes
    if px not in sizes:
        raise not_ported(
            f"text at font_scale {font_scale} (pixel size {px})",
            f"the port's font data covers pixel sizes round(font_scale * 20) = "
            f"{sizes[0]}-{sizes[-1]}", "8")
    return px


def _check_text(text: str) -> None:
    cmap = _data().cmap
    bad = [c for c in text if not FIRST_CHAR <= ord(c) <= LAST_CHAR or cmap[ord(c) - FIRST_CHAR] < 0]
    if bad:
        raise not_ported(f"text with the character {bad[0]!r}",
                         "the port's font data covers printable ASCII (0x20-0x7E) and Latin-1 "
                         "(0xA0-0xFF)", "8")


def _layout(text: str, px: int):
    """Pillow's layout of ``text``: glyph indices, their pen positions in
    whole pixels, and the text box (x_min, x_max, y_min, y_max) in pixels,
    y up from the baseline."""
    _check_text(text)
    data = _data()
    size = data.size(px)
    placed = data.glyphs(text)
    shaped = [g for g in placed if g >= 0]  # kerning pairs skip the soft hyphens
    space = int(data.cmap[ord(" ") - FIRST_CHAR])
    gl, pens = [], []
    position = x_min = x_max = y_min = y_max = k = 0
    for g in placed:
        p = _pixel(position)
        pens.append(p)
        if g < 0:  # a soft hyphen: the space glyph, no advance
            g = space
        else:
            k += 1
            position += int(size.advance[g]) + (size.kern.get((g, shaped[k]), 0)
                                                if k < len(shaped) else 0)
        gl.append(g)
        x_max = max(x_max, _pixel(position))
        x0, y0, x1, y1 = size.cbox[g]
        x_min, x_max = min(x_min, x0 + p), max(x_max, x1 + p)
        y_min, y_max = min(y_min, y0), max(y_max, y1)
    return size, gl, pens, (x_min, x_max, y_min, y_max)


@lru_cache(maxsize=256)
def rasterize(text: str, font_scale: float) -> Tuple[np.ndarray, int, int]:
    """Rasterize ``text`` → (mask, dx, dy), the reference's contract.

    mask: (ascent + descent, bucketed width) u8 coverage (read-only: it is
    cached); (dx, dy) = (0, -ascent) is the offset from the baseline origin
    ``org`` to the mask's top-left corner."""
    from .. import native

    px = _px_size(font_scale)
    size, gl, pens, (x_min, x_max, y_min, y_max) = _layout(text, px)
    asc = size.ascent
    canvas = np.zeros((asc + size.descent, _bucket(max(1, x_max - x_min))), np.uint8)
    for g, p in zip(gl, pens):
        native.text_glyph(size.points[g], size.on_curve[g], size.ends[g], canvas,
                          org=(p - x_min, asc), clip=(0, asc - y_max, x_max - x_min, asc - y_min))
    canvas.setflags(write=False)
    return canvas, 0, -asc


def get_text_size(text: str, font_scale: float) -> Tuple[Tuple[int, int], int]:
    """OpenCV ``getTextSize`` role: ((width, height above the baseline),
    descent), the box ``put_text`` covers at this scale."""
    px = _px_size(font_scale)
    size, _, _, (x_min, x_max, _, _) = _layout(text, px)
    return (max(1, x_max - x_min), size.ascent), size.descent


def put_text_host(img_view: np.ndarray, text: str, org_xy: Tuple[int, int], font_scale: float,
                  color_bgr: tuple) -> None:
    """Host put_text: rasterize, then the integer blend, in place on a
    (rows, cols, 3) u8 view."""
    from . import golden

    mask, dx, dy = rasterize(text, font_scale)
    golden.blend_mask(img_view, mask, org_xy[0] + dx, org_xy[1] + dy, color_bgr)
