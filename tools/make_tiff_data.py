"""Write ``tests/data/tiff/``: TIFF files with new-style JPEG compression
and with the YCbCr photometric (ROADMAP Queue 1 item 8d-ii-c-i), which
``chip_smoke.py`` reads on the card (phase 3zc) and
``tests/test_torch_tiff_jpeg_ycbcr.py`` reads here, and their
``manifest.json``.

Run it only where Pillow 12.1 (its bundled libtiff 4.7 and libjpeg-turbo
3.1) and the JAX package are. The files are Pillow's own JPEG writes (RGB,
L, LA, CMYK, YCbCr and a multi-page file; each ``save`` runs in a process of
its own, since a failed libtiff JPEG write can corrupt the heap of the
process that made it) and pages built here with ``chip_smoke.tiff_file``:
strips and tiles whose JPEG streams Pillow's JPEG encoder writes (tables in
JPEGTables, in the strips or both, restart markers, a last strip of the
rows left or of a whole RowsPerStrip, a strip whose stream is short, planar
pages, YCbCrSubsampling wrong or missing, II and MM, every photometric),
YCbCr in data units on LZW, Deflate and PackBits (subsamplings 1, 2 and 4,
YCbCrCoefficients and ReferenceBlackWhite, predictor 2, orientations,
libtiff's own quirks at 4x4), and the forms that stay refused or fail
(old-style JPEG, uncompressed YCbCr, a cut strip, a strip without SOI). The
port never runs it, and nothing at run time needs Pillow.

    python tools/make_tiff_data.py [--out DIR]

The manifest holds, per file: its form, its SHA-256 and size, the
reference's page count (``rustcv_tpu.cv2.imcount``, 0 where it fails), its
``imread`` ("read" or the class of its error), and its pages as Pillow's
``ImageSequence`` reads them (each page's shape and the SHA-256 of its BGR
bytes, or the class of the error that ends the walk). Writing is
deterministic: a second run rewrites the directory byte for byte.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import io
import json
import os
import pickle
import struct
import subprocess
import sys
import tempfile
import warnings
from fractions import Fraction

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "tiff")
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402 - the repo's TIFF writer


def pattern(w: int, h: int, seed: int = 0) -> np.ndarray:
    """A smooth RGB test pattern with seeded noise, u8 (H, W, 3)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    rng = np.random.default_rng(seed)
    img = np.stack([128 + 100 * np.sin(xx / (5.0 + seed % 4) + yy / 13.0),
                    128 + 90 * np.cos(yy / 7.0 - xx / 19.0),
                    128 + 80 * np.sin((xx + 2 * yy) / 11.0)], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def pillow_jpeg(img: np.ndarray, **kw) -> bytes:
    """Pillow's JPEG of u8 (H, W, 1, 3 or 4) samples (L, RGB, CMYK)."""
    from PIL import Image

    img = np.ascontiguousarray(img)
    mode = {1: "L", 3: "RGB", 4: "CMYK"}[img.shape[2]]
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def segments(data: bytes):
    """([(marker, segment bytes)] before the first SOS, the rest)."""
    p, out = 2, []
    while data[p + 1] != 0xDA:
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        out.append((data[p + 1], data[p:p + 2 + n]))
        p += 2 + n
    return out, data[p:]


def split_tables(data: bytes, keep: bool = False):
    """(a JPEGTables stream of the DQT and DHT segments, the stream without
    them, or with them where ``keep``)."""
    segs, rest = segments(data)
    tables = b"".join(s for m, s in segs if m in (0xDB, 0xC4))
    body = b"".join(s for m, s in segs if keep or m not in (0xDB, 0xC4))
    return b"\xff\xd8" + tables + b"\xff\xd9", b"\xff\xd8" + body + rest


def rationals(values) -> list:
    out = []
    for v in values:
        f = Fraction(v).limit_denominator(100000)
        out += [f.numerator, f.denominator]
    return out


def jpeg_page(samples, photo=6, sub=2, quality=80, tables=None, order="II", **kw) -> bytes:
    """One page of JPEG strips or tiles, each Pillow's JPEG of its samples
    (``sub`` Pillow's subsampling); ``tables`` "only" moves every stream's
    DQT and DHT into JPEGTables, "both" copies them there."""
    made, jpeg_kw = {}, kw.pop("jpeg_kw", {})

    def enc(blk, plane):
        j = pillow_jpeg(blk, quality=quality, subsampling=sub, **jpeg_kw)
        if tables is None:
            return j
        made["t"], body = split_tables(j, keep=tables == "both")
        return body

    pg = dict(samples=samples, photo=photo, comp=7, jpeg=enc, **kw)
    data = S.tiff_file([pg], order)
    if tables is not None:
        pg["tags"] = {**pg.get("tags", {}), 347: (7, list(made["t"]))}
        data = S.tiff_file([pg], order)
    return data


def strip_coder(fn):
    """A ``jpeg`` function that calls ``fn(i, samples)`` with the index of
    each strip or tile."""
    seen = []

    def enc(blk, plane):
        seen.append(1)
        return fn(len(seen) - 1, np.ascontiguousarray(blk))

    return enc


def pillow_tiff(kind: str) -> bytes:
    """A Pillow JPEG TIFF write, made in a process of its own."""
    code = ("import io, pickle, sys, numpy as np; from PIL import Image; "
            "sys.path.insert(0, %r); from make_tiff_data import pillow_frames; "
            "sys.stdout.buffer.write(pickle.dumps(pillow_frames(%r)))"
            % (os.path.join(ROOT, "tools"), kind))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, check=True)
    return pickle.loads(out.stdout)


def pillow_frames(kind: str) -> bytes:
    from PIL import Image

    rgb = pattern(41, 27, 3)
    buf = io.BytesIO()
    if kind == "pages":
        frames = [Image.fromarray(rgb), Image.fromarray(rgb).convert("L"),
                  Image.fromarray(pattern(23, 19, 4)).convert("YCbCr")]
        frames[0].save(buf, "TIFF", compression="jpeg", quality=70, save_all=True,
                       append_images=frames[1:])
    else:
        mode, quality = kind.split("_")
        Image.fromarray(rgb).convert(mode).save(buf, "TIFF", compression="jpeg",
                                                quality=int(quality))
    return buf.getvalue()


def fixtures() -> dict:
    """{name: (form, bytes)}."""
    w, h = 37, 29
    rgb = pattern(w, h, 1)
    ycc = pattern(w, h, 2)  # samples taken as Y, Cb, Cr
    gray = rgb[..., :1].copy()
    f = {}
    for kind in ("RGB_80", "L_75", "LA_85", "CMYK_90", "YCbCr_60", "pages"):
        f[f"pillow_jpeg_{kind.lower()}.tif"] = ("jpeg", pillow_tiff(kind))
    for sub, tag in ((0, (1, 1)), (1, (2, 1)), (2, (2, 2))):
        name = {0: "444", 1: "422", 2: "420"}[sub]
        f[f"jpeg_ycbcr_{name}.tif"] = ("jpeg", jpeg_page(rgb, sub=sub, ycbcr=tag))
    f["jpeg_tiles_420.tif"] = ("jpeg", jpeg_page(rgb, tile=(16, 16), ycbcr=(2, 2), tables="only"))
    f["jpeg_tiles_422_mm.tif"] = ("jpeg", jpeg_page(rgb, sub=1, tile=(32, 16), ycbcr=(2, 1),
                                                    order="MM"))
    f["jpeg_strips_420.tif"] = ("jpeg", jpeg_page(rgb, rows=8, ycbcr=(2, 2), tables="only"))
    f["jpeg_strips_odd_rows.tif"] = ("jpeg", jpeg_page(rgb, rows=5, ycbcr=(2, 2)))

    def full_last(i, blk):  # the last strip written with a whole RowsPerStrip
        if blk.shape[0] < 8:
            blk = np.concatenate([blk, np.repeat(blk[-1:], 8 - blk.shape[0], 0)])
        return pillow_jpeg(blk, quality=80, subsampling=2)

    f["jpeg_strips_full_last.tif"] = ("jpeg", S.tiff_file([dict(
        samples=rgb, photo=6, comp=7, rows=8, ycbcr=(2, 2), jpeg=strip_coder(full_last))]))
    f["jpeg_tables_both.tif"] = ("jpeg", jpeg_page(rgb, rows=16, ycbcr=(2, 2), tables="both"))

    def first_tables(i, blk):  # libjpeg keeps the first strip's tables for the rest
        j = pillow_jpeg(blk, quality=60 + 9 * i, subsampling=0)
        return j if i == 0 else split_tables(j)[1]

    f["jpeg_tables_first_strip.tif"] = ("jpeg", S.tiff_file([dict(
        samples=rgb, photo=6, comp=7, rows=8, ycbcr=(1, 1), jpeg=strip_coder(first_tables))]))
    f["jpeg_restart.tif"] = ("jpeg", jpeg_page(rgb, ycbcr=(2, 2), tables="only", rows=16,
                                               jpeg_kw=dict(restart_marker_blocks=3)))
    f["jpeg_progressive.tif"] = ("jpeg", jpeg_page(rgb, ycbcr=(2, 2), rows=16,
                                                   jpeg_kw=dict(progressive=True)))
    f["jpeg_no_subsampling_tag.tif"] = ("jpeg", jpeg_page(rgb, sub=1, ycbcr=(2, 1),
                                                          tags={530: None}))
    f["refused_jpeg_wrong_subsampling_tag.tif"] = ("refused", jpeg_page(rgb, sub=1,
                                                                        ycbcr=(2, 2)))
    f["jpeg_planar_rgb.tif"] = ("jpeg", jpeg_page(rgb, photo=2, sub=0, planar=2, rows=16))
    f["jpeg_planar_ycbcr.tif"] = ("jpeg", jpeg_page(ycc, sub=0, planar=2, ycbcr=(1, 1),
                                                    tile=(16, 16)))
    f["jpeg_rgb_holding_ycbcr.tif"] = ("jpeg", jpeg_page(rgb, photo=2, sub=0))
    f["jpeg_gray.tif"] = ("jpeg", jpeg_page(gray, photo=1, sub=0, tile=(16, 16)))
    f["jpeg_white_is_zero.tif"] = ("jpeg", jpeg_page(gray, photo=0, sub=0, order="MM"))
    f["jpeg_palette.tif"] = ("jpeg", jpeg_page(gray, photo=3, sub=0, colormap=np.random.default_rng(
        5).integers(0, 65536, 768)))
    rgba = np.concatenate([rgb, rgb[..., 1:2]], 2)
    f["jpeg_rgba.tif"] = ("jpeg", jpeg_page(rgba, photo=2, sub=0, extra=(2,), rows=16))
    f["jpeg_cmyk.tif"] = ("jpeg", jpeg_page(rgba, photo=5, sub=0, tile=(16, 16)))

    def short_second(i, blk):  # stream 1 holds 5 rows and 30 columns of its 8 x 37
        return pillow_jpeg(blk[:5, :30] if i == 1 else blk, quality=80, subsampling=0)

    f["jpeg_short_strip.tif"] = ("jpeg", S.tiff_file([dict(
        samples=rgb, photo=6, comp=7, rows=8, ycbcr=(1, 1), jpeg=strip_coder(short_second))]))
    f["jpeg_multipage.tif"] = ("jpeg", S.tiff_file([
        dict(samples=rgb, photo=6, comp=7, ycbcr=(2, 2), rows=16,
             jpeg=lambda b, p: pillow_jpeg(b, quality=85, subsampling=2)),
        dict(samples=pattern(23, 17, 6), photo=2, comp=5, predictor=2),
        dict(samples=pattern(19, 13, 7), photo=6, comp=8, ycbcr=(2, 1)),
        dict(samples=gray[:20, :30], photo=1, comp=7,
             jpeg=lambda b, p: pillow_jpeg(b, quality=50))]))
    # YCbCr in data units
    coeffs = {529: (5, rationals([0.2126, 0.7152, 0.0722])),
              532: (5, rationals([16, 235, 128, 240, 128, 240]))}
    for comp, name, sub, kw in ((5, "lzw_11", (1, 1), {}), (8, "deflate_21", (2, 1), {"rows": 8}),
                                (32773, "packbits_22", (2, 2), {"rows": 7}),
                                (32946, "deflate_42", (4, 2), {}),
                                (5, "lzw_22_tiles", (2, 2), {"tile": (16, 16)}),
                                (8, "deflate_12", (1, 2), {}), (5, "lzw_41", (4, 1), {}),
                                (8, "deflate_22_coefficients", (2, 2), {"tags": coeffs}),
                                (5, "lzw_22_predictor", (2, 2), {"predictor": 2, "rows": 8}),
                                (5, "lzw_21_predictor_ragged", (2, 1), {"predictor": 2}),
                                (8, "deflate_44_tiles", (4, 4), {"tile": (16, 16)}),
                                (8, "deflate_44_strips", (4, 4), {"rows": 7}),
                                (8, "deflate_22_orientation_6", (2, 2), {"tags": {274: (3, [6])}}),
                                (5, "lzw_42_orientation_3", (4, 2), {"tags": {274: (3, [3])}}),
                                (32773, "packbits_planar", (1, 1), {"planar": 2})):
        order = "MM" if comp == 32773 else "II"
        f[f"ycbcr_{name}.tif"] = ("ycbcr", S.tiff_file(
            [dict(samples=ycc, photo=6, comp=comp, ycbcr=sub, **kw)], order))
    f["ycbcr_raw_padded.tif"] = ("ycbcr", S.tiff_file([dict(samples=ycc, photo=6,
                                                            ycbcr=(1, 1))]) + bytes(1200))
    # what stays refused or fails
    f["refused_old_style_jpeg.tif"] = ("not_ported", old_style_jpeg(rgb))
    f["refused_ycbcr_raw.tif"] = ("refused", S.tiff_file([dict(samples=ycc, photo=6,
                                                               ycbcr=(1, 1))]))
    f["refused_jpeg_cut_header.tif"] = ("refused", S.tiff_file([dict(
        samples=rgb, photo=6, comp=7, ycbcr=(2, 2), rows=16,
        jpeg=lambda b, p: pillow_jpeg(b, quality=80, subsampling=2)[:160])]))
    f["refused_jpeg_no_soi.tif"] = ("refused", S.tiff_file([dict(
        samples=rgb, photo=6, comp=7, ycbcr=(2, 2),
        jpeg=lambda b, p: pillow_jpeg(b, quality=80, subsampling=2)[2:])]))
    f["refused_jpeg_ycbcr_gray.tif"] = ("refused", jpeg_page(gray, photo=6))
    f["refused_jpeg_gray_2x2.tif"] = ("refused", jpeg_page(gray, photo=1, sub=2))
    f["refused_jpeg_rgb_420.tif"] = ("refused", jpeg_page(rgb, photo=2, sub=2))
    f["refused_second_page.tif"] = ("refused", S.tiff_file([
        dict(samples=rgb, photo=6, comp=7, ycbcr=(2, 2),
             jpeg=lambda b, p: pillow_jpeg(b, quality=80, subsampling=2)),
        dict(samples=rgb, photo=6, comp=7, ycbcr=(1, 1),
             jpeg=lambda b, p: pillow_jpeg(b, quality=80, subsampling=2))]))
    f["refused_ycbcr_planar_22.tif"] = ("refused", S.tiff_file([dict(
        samples=ycc, photo=6, comp=8, planar=2, ycbcr=(2, 2))]))
    return f


def old_style_jpeg(rgb: np.ndarray) -> bytes:
    """Compression 6 with JPEGInterchangeFormat (513, 514) at a whole JFIF
    stream, which libtiff's OJPEG codec reads."""
    j = pillow_jpeg(rgb, quality=80, subsampling=2)
    d = S.tiff_file([dict(samples=rgb, photo=6, comp=7, ycbcr=(2, 2), jpeg=lambda b, p: j)])
    from rustcv_tpu_torch.imgcodecs.tiff import Tiff

    s = Tiff(d).setup(0)
    off, cnt = s["offsets"][0], s["counts"][0]
    return S.tiff_file([dict(samples=rgb, photo=6, comp=7, ycbcr=(2, 2), jpeg=lambda b, p: j,
                             tags={259: (3, [6]), 513: (4, [off]), 514: (4, [cnt])})])


def _outcome(fn) -> str:
    """"read", or the class name of what ``fn`` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is the answer
        return type(e).__name__
    return "read"


def truth(form: str, data: bytes, tmp: str) -> dict:
    """The manifest entry of one file: the reference's answers."""
    from PIL import Image, ImageSequence

    import rustcv_tpu.cv2 as ref_cv2
    from rustcv_tpu import imgcodecs

    path = os.path.join(tmp, "f.tif")
    with open(path, "wb") as f:
        f.write(data)
    entry = {"form": form, "bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(),
             "count": ref_cv2.imcount(path), "imread": _outcome(lambda: imgcodecs.imread(path))}
    pages = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            for frame in ImageSequence.Iterator(Image.open(path)):
                bgr = np.ascontiguousarray(np.asarray(frame.convert("RGB"))[..., ::-1])
                pages.append({"shape": list(bgr.shape),
                              "bgr_sha256": hashlib.sha256(bgr.tobytes()).hexdigest()})
        except Exception as e:  # noqa: BLE001 - the class is the answer
            pages.append({"error": type(e).__name__})
    entry["pages"] = pages
    return entry


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.makedirs(args.out, exist_ok=True)
    for old in glob.glob(os.path.join(args.out, "*.tif")):
        os.remove(old)
    manifest = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (form, data) in sorted(fixtures().items()):
            with open(os.path.join(args.out, name), "wb") as f:
                f.write(data)
            manifest[name] = truth(form, data, tmp)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(p) for p in glob.glob(os.path.join(args.out, "*")))
    print(f"make_tiff_data: {len(manifest)} files and manifest.json, {total} bytes in {args.out}")


if __name__ == "__main__":
    main()
