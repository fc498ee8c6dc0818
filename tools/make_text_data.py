"""Generate ``rustcv_tpu_torch/assets/dejavusans_text.npz``, the font data
behind ``rustcv_tpu_torch.ops.text``.

Run it only where Pillow with raqm is present (``PIL.features.check("raqm")``):
it loads the FreeType and HarfBuzz libraries that Pillow's wheel bundles,
with ctypes, and reads from them what Pillow's raqm layout uses. The port
never runs it, and nothing at run time needs Pillow, FreeType or HarfBuzz.

    python tools/make_text_data.py [--out PATH] [--min-size 1] [--max-size 160] [--jobs 8]

The characters are printable ASCII and Latin-1's U+00A0-U+00FF (``CHARS``).
Per pixel size (``round(font_scale * 20)``), the tables are:

* ``metrics``: ascent and descent as ``ImageFont.getmetrics()`` gives them;
* every glyph that HarfBuzz makes from those characters, ligatures
  included, as its hinted outline (``FT_LOAD_DEFAULT``): 26.6 points,
  on-curve flags and contour ends;
* ``advance``: HarfBuzz's advance of each glyph (26.6), and ``kern``: its
  adjustment of every glyph pair where it is not zero (every pair of
  characters and ligatures is shaped at every size);
* the ligature rules (``lig_seq`` → ``lig_out``), in the order they apply.

The soft hyphen (U+00AD) is default-ignorable: HarfBuzz shapes the text as
if it were not there (ligatures and kerning reach across it) and shows it
as the space glyph with no advance, right after the glyph of the character
before it (``Layout``).

Before it writes the file, the script checks that these tables reproduce
HarfBuzz's glyphs and positions on random strings at every size (soft
hyphens among them), and that the port's rasterizer
(``rustcv_tpu_torch.native.text_glyph``) renders every glyph at every size
as FreeType's ``FT_Render_Glyph`` does, byte for byte; it prints the
counts. The sizes run in ``--jobs`` processes.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import glob
import itertools
import os
import random
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FONT = os.path.join(ROOT, "rustcv_tpu_torch", "assets", "DejaVuSans.ttf")
OUT = os.path.join(ROOT, "rustcv_tpu_torch", "assets", "dejavusans_text.npz")
ASCII = "".join(chr(c) for c in range(0x20, 0x7F))
CHARS = ASCII + "".join(chr(c) for c in range(0xA0, 0x100))
SOFT_HYPHEN = "\xad"
SHAPED = CHARS.replace(SOFT_HYPHEN, "")  # the characters that shape to a glyph of their own
FIRST, LAST = 0x20, 0xFF  # the cmap's range; -1 where a code is not in CHARS


def _libs():
    import PIL
    from PIL import _imagingft  # noqa: F401 — loads the bundled libraries' dependencies
    from PIL import features

    if not features.check("raqm"):
        sys.exit("make_text_data: Pillow here has no raqm; the tables would not be its layout")
    libdir = os.path.realpath(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs"))
    ft = ctypes.CDLL(glob.glob(os.path.join(libdir, "libfreetype-*.so*"))[0])
    hb = ctypes.CDLL(glob.glob(os.path.join(libdir, "libharfbuzz-*.so*"))[0])
    return ft, hb


c_long, c_int, c_uint, c_void_p = ctypes.c_long, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p
c_short, c_ushort = ctypes.c_short, ctypes.c_ushort


class _Vec(ctypes.Structure):
    _fields_ = [("x", c_long), ("y", c_long)]


class _Generic(ctypes.Structure):
    _fields_ = [("data", c_void_p), ("finalizer", c_void_p)]


class _BBox(ctypes.Structure):
    _fields_ = [("xMin", c_long), ("yMin", c_long), ("xMax", c_long), ("yMax", c_long)]


class _Bitmap(ctypes.Structure):
    _fields_ = [("rows", c_uint), ("width", c_uint), ("pitch", c_int), ("buffer", c_void_p),
                ("num_grays", c_ushort), ("pixel_mode", ctypes.c_ubyte),
                ("palette_mode", ctypes.c_ubyte), ("palette", c_void_p)]


class _Outline(ctypes.Structure):
    _fields_ = [("n_contours", c_ushort), ("n_points", c_ushort), ("points", ctypes.POINTER(_Vec)),
                ("tags", ctypes.POINTER(ctypes.c_ubyte)), ("contours", ctypes.POINTER(c_ushort)),
                ("flags", c_int)]


class _Slot(ctypes.Structure):
    _fields_ = [("library", c_void_p), ("face", c_void_p), ("next", c_void_p),
                ("glyph_index", c_uint), ("generic", _Generic), ("metrics", c_long * 8),
                ("linear_hori", c_long), ("linear_vert", c_long), ("advance", _Vec),
                ("format", c_uint), ("bitmap", _Bitmap), ("bitmap_left", c_int),
                ("bitmap_top", c_int), ("outline", _Outline)]


class _Face(ctypes.Structure):
    _fields_ = [("num_faces", c_long), ("face_index", c_long), ("face_flags", c_long),
                ("style_flags", c_long), ("num_glyphs", c_long), ("family_name", c_void_p),
                ("style_name", c_void_p), ("num_fixed_sizes", c_int), ("available_sizes", c_void_p),
                ("num_charmaps", c_int), ("charmaps", c_void_p), ("generic", _Generic),
                ("bbox", _BBox), ("units_per_em", c_ushort), ("ascender", c_short),
                ("descender", c_short), ("height", c_short), ("max_advance_width", c_short),
                ("max_advance_height", c_short), ("underline_position", c_short),
                ("underline_thickness", c_short), ("glyph", ctypes.POINTER(_Slot))]


class _HbInfo(ctypes.Structure):
    _fields_ = [("codepoint", ctypes.c_uint32), ("mask", ctypes.c_uint32),
                ("cluster", ctypes.c_uint32), ("var1", ctypes.c_uint32), ("var2", ctypes.c_uint32)]


class _HbPos(ctypes.Structure):
    _fields_ = [("x_advance", ctypes.c_int32), ("y_advance", ctypes.c_int32),
                ("x_offset", ctypes.c_int32), ("y_offset", ctypes.c_int32), ("var", ctypes.c_uint32)]


class Font:
    """One face at one pixel size, set up as Pillow's raqm layout sets it up:
    ``FT_Set_Pixel_Sizes(face, 0, px)``, glyphs loaded with
    ``FT_LOAD_DEFAULT``, and a HarfBuzz font over the face with hb-ft's
    default load flags (raqm is given none), which make unhinted advances."""

    def __init__(self, ft, hb, library, px: int):
        self.ft, self.hb, self.px = ft, hb, px
        self.face_p = c_void_p()
        if ft.FT_New_Face(library, FONT.encode(), 0, ctypes.byref(self.face_p)):
            raise OSError(f"FT_New_Face failed for {FONT}")
        if ft.FT_Set_Pixel_Sizes(self.face_p, 0, px):
            raise OSError(f"FT_Set_Pixel_Sizes({px}) failed")
        self.face = ctypes.cast(self.face_p, ctypes.POINTER(_Face)).contents
        self.hb_font = hb.hb_ft_font_create_referenced(self.face_p)

    def shape(self, text: str):
        """[(glyph, x_advance, y_advance, x_offset, y_offset)] from HarfBuzz."""
        hb = self.hb
        buf = hb.hb_buffer_create()
        b = text.encode()
        hb.hb_buffer_add_utf8(buf, b, len(b), 0, len(b))
        hb.hb_buffer_set_direction(buf, 4)  # HB_DIRECTION_LTR
        hb.hb_buffer_guess_segment_properties(buf)
        hb.hb_shape(self.hb_font, buf, None, 0)
        n = c_uint()
        info = hb.hb_buffer_get_glyph_infos(buf, ctypes.byref(n))
        pos = hb.hb_buffer_get_glyph_positions(buf, ctypes.byref(n))
        out = [(info[i].codepoint, pos[i].x_advance, pos[i].y_advance, pos[i].x_offset,
                pos[i].y_offset) for i in range(n.value)]
        hb.hb_buffer_destroy(buf)
        return out

    def render(self, glyph: int):
        """FreeType's own coverage bitmap of the hinted glyph:
        ((rows, width) u8, bitmap_left, bitmap_top)."""
        if self.ft.FT_Load_Glyph(self.face_p, glyph, 0) or self.ft.FT_Render_Glyph(
                self.face.glyph, 0):  # FT_RENDER_MODE_NORMAL
            raise OSError(f"rendering glyph {glyph} failed")
        slot = self.face.glyph.contents
        bm = slot.bitmap
        rows = [np.ctypeslib.as_array(ctypes.cast(bm.buffer + r * bm.pitch,
                                                  ctypes.POINTER(ctypes.c_ubyte)), (bm.width,))
                for r in range(bm.rows)] if bm.width else []
        out = np.array(rows, np.uint8).reshape(bm.rows, bm.width)
        return out, slot.bitmap_left, slot.bitmap_top

    def outline(self, glyph: int):
        """The hinted outline: (points [P, 2] 26.6, on-curve [P], contour ends [C])."""
        if self.ft.FT_Load_Glyph(self.face_p, glyph, 0):  # FT_LOAD_DEFAULT
            raise OSError(f"FT_Load_Glyph({glyph}) failed")
        o = self.face.glyph.contents.outline
        if o.flags & 0x40:  # FT_OUTLINE_OVERLAP: FreeType would oversample it
            raise ValueError(f"glyph {glyph} has overlapping contours")
        pts = np.array([(o.points[i].x, o.points[i].y) for i in range(o.n_points)],
                       np.int64).reshape(-1, 2)
        tags = np.array([o.tags[i] for i in range(o.n_points)], np.int64)
        if (tags & 2).any():
            raise ValueError(f"glyph {glyph} has cubic points")
        ends = np.array([o.contours[i] for i in range(o.n_contours)], np.int64)
        return pts, (tags & 1).astype(np.uint8), ends


def _bind(ft, hb):
    hb.hb_ft_font_create_referenced.restype = c_void_p
    hb.hb_ft_font_create_referenced.argtypes = [c_void_p]
    hb.hb_buffer_create.restype = c_void_p
    hb.hb_buffer_add_utf8.argtypes = [c_void_p, ctypes.c_char_p, c_int, c_uint, c_int]
    hb.hb_buffer_guess_segment_properties.argtypes = [c_void_p]
    hb.hb_buffer_set_direction.argtypes = [c_void_p, c_int]
    hb.hb_shape.argtypes = [c_void_p, c_void_p, c_void_p, c_uint]
    hb.hb_buffer_get_glyph_infos.restype = ctypes.POINTER(_HbInfo)
    hb.hb_buffer_get_glyph_infos.argtypes = [c_void_p, ctypes.POINTER(c_uint)]
    hb.hb_buffer_get_glyph_positions.restype = ctypes.POINTER(_HbPos)
    hb.hb_buffer_get_glyph_positions.argtypes = [c_void_p, ctypes.POINTER(c_uint)]
    hb.hb_buffer_destroy.argtypes = [c_void_p]
    ft.FT_Load_Glyph.argtypes = [c_void_p, c_uint, ctypes.c_int32]
    ft.FT_Render_Glyph.argtypes = [ctypes.POINTER(_Slot), c_int]


def _lig_worker(first: str) -> tuple:
    """The strings of two and three characters from ``first`` that shape to
    one glyph, and those that shape to neither one glyph nor one per
    character."""
    font = _worker_font(20)
    whole, odd = {}, []
    for t in itertools.chain(((c,) for c in SHAPED), itertools.product(SHAPED, repeat=2)):
        s = first + "".join(t)
        g = font.shape(s)
        if len(g) == 1:
            whole[s] = g[0][0]
        elif len(g) != len(s):
            odd.append(s)
    return whole, odd


def find_ligatures(pool) -> list:
    """Every string of the characters (but the soft hyphen) that HarfBuzz
    shapes to fewer glyphs than characters, up to 4 characters long
    (``(string, glyph)``, longest first): every string of 2 and 3, then 4
    from the heads of those found."""
    ligs, odd = {}, []
    for whole, o in pool.map(_lig_worker, SHAPED):
        ligs.update(whole)
        odd += o
    for s in odd:
        if not any(s[i:] in ligs or s[:i] in ligs for i in range(1, len(s))):
            raise ValueError(f"{s!r} shapes to neither one glyph nor one per character")
    font = _worker_font(20)
    for h in {s[:2] for s in ligs}:
        for t in itertools.product(SHAPED, repeat=2):
            s = h + "".join(t)
            g = font.shape(s)
            if len(g) == 1:
                ligs[s] = g[0][0]
    return sorted(ligs.items(), key=lambda kv: (-len(kv[0]), kv[0]))


class Layout:
    """The tables' layout of a string, as ``rustcv_tpu_torch.ops.text`` does
    it: soft hyphens set aside, greedy ligatures, then each glyph's advance
    plus the kerning of the pair it starts; each soft hyphen comes back as
    the space glyph with no advance, after the glyph that holds the
    character before it."""

    def __init__(self, cmap, ligs, advance, kern):
        self.cmap, self.ligs, self.advance, self.kern = cmap, ligs, advance, kern

    def glyphs(self, plain: str):
        """[(glyph, characters it takes)] of a string with no soft hyphen."""
        out, i = [], 0
        while i < len(plain):
            for s, g in self.ligs:
                if plain.startswith(s, i):
                    out.append((g, len(s)))
                    break
            else:
                out.append((self.cmap[plain[i]], 1))
            i += out[-1][1]
        return out

    def positions(self, text: str):
        runs = self.glyphs(text.replace(SOFT_HYPHEN, ""))
        gl = [g for g, _ in runs]
        adv = [self.advance[g] + (self.kern.get((g, gl[i + 1]), 0) if i + 1 < len(gl) else 0)
               for i, g in enumerate(gl)]
        out_g, out_a, k, start, seen = [], [], 0, 0, 0
        for c in text:
            if c != SOFT_HYPHEN:
                seen += 1
                continue
            while k < len(gl) and start < seen:  # the glyphs that start before it
                out_g.append(gl[k])
                out_a.append(adv[k])
                start += runs[k][1]
                k += 1
            out_g.append(self.cmap[" "])
            out_a.append(0)
        return out_g + gl[k:], out_a + adv[k:]


_WORKER = {}


def _worker_font(px: int) -> "Font":
    """This process's Font at ``px`` (the libraries loaded once per process)."""
    if "library" not in _WORKER:
        ft, hb = _libs()
        _bind(ft, hb)
        library = c_void_p()
        if ft.FT_Init_FreeType(ctypes.byref(library)):
            raise OSError("FT_Init_FreeType failed")
        _WORKER.update(ft=ft, hb=hb, library=library)
    return Font(_WORKER["ft"], _WORKER["hb"], _WORKER["library"], px)


def extract(px: int, ligs) -> dict:
    """One size's tables, checked against HarfBuzz and FreeType."""
    from PIL import ImageFont

    font = _worker_font(px)
    rng = random.Random(px)
    cmap = {c: font.shape(c)[0][0] for c in SHAPED}
    glyphs = sorted(set(cmap.values()) | {g for _, g in ligs})
    advance = {}
    units = list(SHAPED) + [s for s, _ in ligs]
    for u in units:
        (g, xa, ya, xo, yo), = font.shape(u)
        if (ya, xo, yo) != (0, 0, 0):
            raise ValueError(f"{u!r} at {px}px: y advance or offsets {(ya, xo, yo)}")
        if advance.setdefault(g, xa) != xa:
            raise ValueError(f"{u!r} at {px}px: glyph {g} with two advances")
    (g, xa, *_), = font.shape(SOFT_HYPHEN)
    if (g, xa) != (cmap[" "], 0):
        raise ValueError(f"the soft hyphen at {px}px shapes to {font.shape(SOFT_HYPHEN)}")
    glyph_of = {u: font.shape(u)[0][0] for u in units}
    kern = {}
    for u1, u2 in itertools.product(units, repeat=2):
        sh = font.shape(u1 + u2)
        g1, g2 = glyph_of[u1], glyph_of[u2]
        if [s[0] for s in sh] != [g1, g2]:
            continue  # the pair makes a ligature: never adjacent glyphs
        if any(s[2:] != (0, 0, 0) for s in sh) or sh[1][1] != advance[g2]:
            raise ValueError(f"{u1 + u2!r} at {px}px: positioning beyond pair kerning")
        if sh[0][1] != advance[g1]:
            kern[(g1, g2)] = sh[0][1] - advance[g1]
    lay = Layout(dict(cmap, **{SOFT_HYPHEN: cmap[" "]}), ligs, advance, kern)
    probe = ["ffi", "ffl", "fff", "fffi", "AVAV", "To", "Wa", "Ty", " f i ", "office", "\xad",
             "A\xadV", "f\xadi", "f\xadf\xadi", "\xad\xadfi\xad", "T\xad\xado", "é\xadà ÿ"]
    probe += ["".join(rng.choice(CHARS) for _ in range(rng.randint(1, 24))) for _ in range(300)]
    probe += ["".join(rng.choice("fil AVTWoayr.,\xad\xc0\xe9\xfd") for _ in range(rng.randint(1, 12)))
              for _ in range(300)]
    for s in probe:
        sh = font.shape(s)
        gl, adv = lay.positions(s)
        if [x[0] for x in sh] != gl or [x[1] for x in sh] != adv or any(x[2:] != (0, 0, 0)
                                                                       for x in sh):
            raise ValueError(f"the tables do not reproduce HarfBuzz on {s!r} at {px}px")
    asc, desc = ImageFont.truetype(FONT, px).getmetrics()
    outlines = {g: font.outline(g) for g in glyphs}
    raster_diffs = sum(not _renders_as_freetype(font, g, *outlines[g]) for g in glyphs)
    return dict(cmap=cmap, glyphs=glyphs, advance=advance, kern=kern, metrics=(asc, desc),
                outlines=outlines, raster_diffs=raster_diffs, probes=len(probe))


def _renders_as_freetype(font: Font, glyph: int, points, on_curve, ends) -> bool:
    """The port's rasterizer against FT_Render_Glyph on one hinted glyph,
    both placed on a canvas with the glyph's origin at (pad, height - pad)."""
    sys.path.insert(0, ROOT)
    from rustcv_tpu_torch import native

    pad = 4 * font.px + 8
    want = np.zeros((2 * pad, 2 * pad), np.uint8)
    bitmap, left, top = font.render(glyph)
    want[pad - top:pad - top + bitmap.shape[0], pad + left:pad + left + bitmap.shape[1]] = bitmap
    got = np.zeros_like(want)
    native.text_glyph(points.astype(np.int32), on_curve, ends.astype(np.int32), got,
                      org=(pad, pad), clip=(0, 0, 2 * pad, 2 * pad))
    return bool((got == want).all())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--min-size", type=int, default=1)
    ap.add_argument("--max-size", type=int, default=160)
    ap.add_argument("--jobs", type=int, default=min(8, os.cpu_count() or 1))
    args = ap.parse_args(argv)
    sizes = list(range(args.min_size, args.max_size + 1))
    with concurrent.futures.ProcessPoolExecutor(args.jobs) as pool:
        ligs = find_ligatures(pool)
        per = list(pool.map(extract, sizes, [ligs] * len(sizes)))
    glyphs = per[0]["glyphs"]
    if any(p["glyphs"] != glyphs or p["cmap"] != per[0]["cmap"] for p in per):
        raise ValueError("the glyph set changes with the size")
    gi = {g: i for i, g in enumerate(glyphs)}
    pairs = sorted({k for p in per for k in p["kern"]})
    pts, on, ends, n_pts, n_ctr = [], [], [], [], []
    for p in per:
        for g in glyphs:
            xy, o, e = p["outlines"][g]
            pts.append(xy)
            on.append(o)
            ends.append(e)
            n_pts.append(len(xy))
            n_ctr.append(len(e))
    points = np.concatenate(pts).astype(np.int64)
    if np.abs(points).max() >= 1 << 15:
        raise ValueError("a point does not fit int16")
    # Points are stored as deltas within each glyph (they compress better).
    deltas = np.concatenate([np.diff(xy, axis=0, prepend=np.zeros((1, 2), np.int64))
                             for xy in pts]).astype(np.int16)
    np.savez_compressed(
        args.out,
        sizes=np.array(sizes, np.int16),
        metrics=np.array([p["metrics"] for p in per], np.int16),
        glyph_ids=np.array(glyphs, np.int32),
        cmap=np.array([gi[per[0]["cmap"][" " if chr(c) == SOFT_HYPHEN else chr(c)]]
                       if chr(c) in CHARS else -1 for c in range(FIRST, LAST + 1)], np.int16),
        lig_text=np.array([s for s, _ in ligs]),
        lig_out=np.array([gi[g] for _, g in ligs], np.int16),
        advance=np.array([[p["advance"][g] for g in glyphs] for p in per], np.int32),
        kern_pairs=np.array([(gi[a], gi[b]) for a, b in pairs], np.int16).reshape(-1, 2),
        kern=np.array([[p["kern"].get(k, 0) for k in pairs] for p in per], np.int16),
        n_points=np.array(n_pts, np.int16).reshape(len(sizes), len(glyphs)),
        n_contours=np.array(n_ctr, np.int16).reshape(len(sizes), len(glyphs)),
        point_deltas=deltas,
        on_curve=np.packbits(np.concatenate(on)),
        contour_ends=np.concatenate(ends).astype(np.int16),
    )
    renders = len(sizes) * len(glyphs)
    bad = sum(p["raster_diffs"] for p in per)
    print(f"make_text_data: the port's rasterizer differs from FT_Render_Glyph on {bad} of "
          f"{renders} glyph renders (every glyph at every size)")
    if bad:
        raise ValueError("the port's rasterizer does not render as FreeType does")
    print(f"make_text_data: the tables reproduce HarfBuzz on {sum(p['probes'] for p in per)} "
          f"strings ({per[0]['probes']} per size)")
    print(f"make_text_data: {len(sizes)} sizes, {len(glyphs)} glyphs, {len(ligs)} ligatures "
          f"{[s for s, _ in ligs]}, {len(pairs)} kerning pairs, {len(points)} points -> "
          f"{args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
