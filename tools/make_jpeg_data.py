"""Write ``tests/data/jpeg/``: the JPEG files of the forms that the host
decode reads since ROADMAP Queue 1 item 8d-ii-b (CMYK and YCCK, libjpeg's
block smoothing of progressive streams left unrefined, lossless SOF3,
arithmetic-coded SOF9 and SOF10, and the forms that stay refused), which
``chip_smoke.py`` reads on the card (phases 3zb, 4zb) and
``tests/test_torch_jpeg_forms.py`` reads here, and their ``manifest.json``.

Run it only where Pillow 12.1 (its bundled libjpeg-turbo 3.1.3), the
system's libjpeg-turbo 2.1.5 with its headers, ``g++`` and the JAX package
are: it builds ``tools/jpeg_fixture_writer.cpp`` twice, against the
system's libjpeg (YCCK, arithmetic coding, hand-made scan scripts, any
sampling) and against Pillow's (``jpeg_enable_lossless``, which 2.1.5 lacks),
writes CMYK with Pillow's ``save`` and subsampled lossless frames with a
small SOF3 writer of its own (libjpeg-turbo 3 writes lossless frames only
at 1x1), cuts progressive streams by whole scans, and reads every file with
the reference. The port never runs it, and
nothing at run time needs Pillow or libjpeg.

    python tools/make_jpeg_data.py [--out DIR]

The files are small (tens of pixels, odd sizes) plus, for phase 4zb, one
1920x1080 file per form and a baseline 4:2:0 one. The manifest holds, per
file: its form, its SHA-256 and size, the shape and the SHA-256 of the
reference's BGR read (``Image.open(...).convert("RGB")``, flipped), the
reference's metadata dict (``imread_with_metadata``), and for each entry
point (``imread``, ``decode_mjpeg_host_rgb``, ``decode_mjpeg_into_mat``)
"read" or the class of the error the reference raises. Writing is
deterministic: a second run rewrites the directory byte for byte.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "jpeg")
WRITER = os.path.join(ROOT, "tools", "jpeg_fixture_writer.cpp")


def pattern(w: int, h: int, seed: int = 0, noise: float = 6.0) -> np.ndarray:
    """A smooth RGB test pattern (sines across and down), with seeded noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    rng = np.random.default_rng(seed)
    img = np.stack([128 + 100 * np.sin(xx / (7.0 + seed % 5) + yy / 23.0),
                    128 + 90 * np.cos(yy / 9.0 - xx / 31.0),
                    128 + 80 * np.sin((xx + 2 * yy) / 17.0)], -1)
    if noise:
        img = img + rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pattern_1080() -> np.ndarray:
    """The 1920x1080 pattern of phase 4zb: smooth, no noise, so it packs."""
    yy, xx = np.mgrid[0:1080, 0:1920].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 97 + yy / 211), 128 + 90 * np.cos(yy / 73 - xx / 300),
                    128 + 80 * np.sin((xx + 2 * yy) / 157)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def cmyk_of(rgb: np.ndarray) -> np.ndarray:
    """Four ink planes of an RGB pattern: Pillow's RGB -> CMYK, and a K
    plane of its own so that K varies."""
    from PIL import Image

    c = np.asarray(Image.fromarray(rgb).convert("CMYK")).copy()
    h, w = rgb.shape[:2]
    c[..., 3] = (np.add.outer(np.arange(h), np.arange(w)) * 3 % 160).astype(np.uint8)
    return c


class Writers:
    """The two builds of ``tools/jpeg_fixture_writer.cpp``."""

    def __init__(self, tmp: str):
        import PIL

        self.tmp = tmp
        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        pillow_jpeg = glob.glob(os.path.join(libs, "libjpeg-*.so*"))[0]
        self.system = os.path.join(tmp, "writer_system")
        self.pillow = os.path.join(tmp, "writer_pillow")
        subprocess.run(["g++", "-O2", "-o", self.system, WRITER, "-ljpeg"], check=True)
        subprocess.run(["g++", "-O2", "-o", self.pillow, WRITER, pillow_jpeg,
                        f"-Wl,-rpath,{libs}"], check=True)

    def write(self, pixels: np.ndarray, jcs: str, lossless: str = None, **kw) -> bytes:
        """libjpeg's file of ``pixels`` ((H, W) gray, (H, W, 3) RGB or
        (H, W, 4) CMYK) in colour space ``jcs``, ``kw`` the writer's
        settings (q, arith, prog, scans, restart, restart_rows, samp, dac)."""
        h, w = pixels.shape[:2]
        incs = {2: "gray", 3: "rgb", 4: "cmyk"}[pixels.ndim if pixels.ndim == 2 else pixels.shape[2]]
        raw = os.path.join(self.tmp, "in.raw")
        out = os.path.join(self.tmp, "out.jpg")
        np.ascontiguousarray(pixels, np.uint8).tofile(raw)
        args = [self.pillow if lossless else self.system, f"in={raw}", f"w={w}", f"h={h}",
                f"incs={incs}", f"jcs={jcs}", f"out={out}"]
        if lossless:
            args.append(f"lossless={lossless}")
        args += [f"{k}={v}" for k, v in kw.items()]
        subprocess.run(args, check=True)
        with open(out, "rb") as f:
            return f.read()


def pillow_jpeg(img: np.ndarray, mode: str = None, **kw) -> bytes:
    """Pillow's save of an RGB array (converted to ``mode`` first)."""
    from PIL import Image

    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


# -- byte surgery ----------------------------------------------------------------


def segments(data: bytes) -> list:
    """[(offset, marker, end)] of the marker segments and scans: a scan's
    end is the next marker past its entropy-coded data."""
    out, p = [], 2
    while p + 4 <= len(data):
        m = data[p + 1]
        if m == 0xD9:
            break
        end = p + 2 + struct.unpack(">H", data[p + 2:p + 4])[0]
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0x00, *range(0xD0, 0xD8))):
                end += 1
        out.append((p, m, end))
        p = end
    return out


def scans(data: bytes) -> list:
    """The scans: dicts of start, end, components (ids), ss, se, ah, al."""
    out = []
    for p, m, end in segments(data):
        if m == 0xDA:
            ns = data[p + 4]
            b = p + 5 + 2 * ns
            out.append({"start": p, "end": end, "comps": [data[p + 5 + 2 * i] for i in range(ns)],
                        "ss": data[b], "se": data[b + 1], "ah": data[b + 2] >> 4,
                        "al": data[b + 2] & 15})
    return out


def drop_scans(data: bytes, pred) -> bytes:
    """The stream without the scans ``pred`` picks (at least one)."""
    drop = [s for s in scans(data) if pred(s)]
    assert drop, "no scan to drop"
    for s in sorted(drop, key=lambda s: -s["start"]):
        data = data[:s["start"]] + data[s["end"]:]
    return data


def drop_segment(data: bytes, marker: int, prefix: bytes = b"") -> bytes:
    """The stream without its first ``marker`` segment whose body starts with ``prefix``."""
    for p, m, end in segments(data):
        if m == marker and data[p + 4:p + 4 + len(prefix)] == prefix:
            return data[:p] + data[end:]
    raise ValueError(f"no 0xFF{marker:02X} segment")


def set_marker(data: bytes, old: int, new: int) -> bytes:
    """The stream with its first ``old`` marker segment's code made ``new``."""
    for p, m, _ in segments(data):
        if m == old:
            return data[:p + 1] + bytes([new]) + data[p + 2:]
    raise ValueError(f"no 0xFF{old:02X} segment")


def set_adobe_transform(data: bytes, t: int) -> bytes:
    for p, m, _ in segments(data):
        if m == 0xEE and data[p + 4:p + 9] == b"Adobe":
            return data[:p + 15] + bytes([t]) + data[p + 16:]
    raise ValueError("no Adobe segment")


def set_precision(data: bytes, bits: int) -> bytes:
    for p, m, _ in segments(data):
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            return data[:p + 4] + bytes([bits]) + data[p + 5:]
    raise ValueError("no frame header")


def set_restart_interval(data: bytes, n: int) -> bytes:
    for p, m, _ in segments(data):
        if m == 0xDD:
            return data[:p + 4] + struct.pack(">H", n) + data[p + 6:]
    raise ValueError("no DRI segment")


# -- a lossless (SOF3) writer of its own ------------------------------------------
# libjpeg-turbo 3's compressor writes lossless frames only in RGB at 1x1;
# this writer makes the subsampled ones, from T.81 Annex H alone.

# T.81 Table K.3, the luminance DC table: categories 0-11 (8-bit
# differences need 0-8)
DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
DC_VALS = tuple(range(12))


def _huff_codes(bits, vals) -> dict:
    codes, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            codes[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _segment(m: int, body: bytes) -> bytes:
    return b"\xff" + bytes([m]) + struct.pack(">H", len(body) + 2) + body


def sof3(planes: list, hv: list, width: int, height: int, psv: int, pt: int = 0,
         ids: bytes = b"RGB", adobe: int = 0) -> bytes:
    """A lossless frame of ``planes`` (each component's samples at its own
    size, ceil(width * h / hmax) x ceil(height * v / vmax)), sampling
    factors ``hv`` [(h, v)], predictor ``psv``, point transform ``pt``, in
    one interleaved scan; an Adobe marker of transform ``adobe`` (None:
    none)."""
    codes = _huff_codes(DC_BITS, DC_VALS)
    hmax, vmax = max(h for h, _ in hv), max(v for _, v in hv)
    mx, my = -(-width // hmax), -(-height // vmax)
    bits = []

    def put(d: int) -> None:
        d = ((d + 32768) & 0xFFFF) - 32768
        s = 0 if d == 0 else int(abs(d)).bit_length()
        code, n = codes[s]
        bits.append(format(code, f"0{n}b"))
        if s:
            bits.append(format(d if d > 0 else d + (1 << s) - 1, f"0{s}b"))

    ups = [np.asarray(p, np.int64) >> pt for p in planes]

    def pred(c: int, y: int, x: int) -> int:
        p = ups[c]
        if y == 0:
            return (1 << (8 - pt - 1)) if x == 0 else int(p[y, x - 1])
        if x == 0:
            return int(p[y - 1, 0])
        ra, rb, rc = int(p[y, x - 1]), int(p[y - 1, x]), int(p[y - 1, x - 1])
        return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]

    for my_i in range(my):
        for mx_i in range(mx):
            for c, (h, v) in enumerate(hv):
                for yy in range(v):
                    for xx in range(h):
                        y, x = my_i * v + yy, mx_i * h + xx
                        real = y < ups[c].shape[0] and x < ups[c].shape[1]
                        put(int(ups[c][y, x]) - pred(c, y, x) if real else 0)
    stream = "".join(bits)
    stream += "1" * (-len(stream) % 8)
    data = bytearray()
    for i in range(0, len(stream), 8):
        b = int(stream[i:i + 8], 2)
        data.append(b)
        if b == 0xFF:
            data.append(0)
    out = b"\xff\xd8"
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    out += _segment(0xC4, b"\x00" + bytes(DC_BITS) + bytes(DC_VALS))
    out += _segment(0xC3, bytes([8]) + struct.pack(">HH", height, width) + bytes([len(hv)]) + b"".join(
        bytes([ids[c], (h << 4) | v, 0]) for c, (h, v) in enumerate(hv)))
    out += _segment(0xDA, bytes([len(hv)]) + b"".join(bytes([ids[c], 0]) for c in range(len(hv)))
                    + bytes([psv, 0, pt]))
    return out + bytes(data) + b"\xff\xd9"


def subsampled(img: np.ndarray, hv: list) -> list:
    """Each channel of ``img`` at its sampling (the mean of its h x v cells)."""
    hmax, vmax = max(h for h, _ in hv), max(v for _, v in hv)
    ht, wd = img.shape[:2]
    planes = []
    for c, (h, v) in enumerate(hv):
        fx, fy = hmax // h, vmax // v
        cw, ch = -(-wd * h // hmax), -(-ht * v // vmax)
        pad = np.pad(img[..., c].astype(np.float64), ((0, ch * fy - ht), (0, cw * fx - wd)),
                     mode="edge")
        planes.append(np.round(pad.reshape(ch, fy, cw, fx).mean((1, 3))).astype(np.uint8))
    return planes


# -- the fixtures ----------------------------------------------------------------

# Band scripts of the writer ("components:Ss-Se:Ah:Al;..."), so that a band
# and its refinements can be cut whole (Pillow's script refines 1..63 at once).
GRAY_BANDS = "0:0-0:0:1;0:1-5:0:1;0:6-63:0:1;0:0-0:1:0;0:1-5:1:0;0:6-63:1:0"
GRAY_1_9 = "0:0-0:0:0;0:1-9:0:0;0:10-63:0:0"
COLOUR_BANDS = ("0,1,2:0-0:0:1;0:1-5:0:2;2:1-63:0:1;1:1-63:0:1;0:6-63:0:2;0:1-5:2:1;"
                "0:6-63:2:1;0,1,2:0-0:1:0;2:1-63:1:0;1:1-63:1:0;0:1-5:1:0;0:6-63:1:0")


def last_refinement(s_list):
    last = [s for s in s_list if s["ah"]][-1]
    return lambda s: s["start"] == last["start"]


def fixtures(wr: Writers) -> dict:
    """name → (form, bytes)."""
    from PIL import Image

    out = {}
    # CMYK and YCCK
    rgb = pattern(37, 29, 1)
    cm = cmyk_of(rgb)
    out["cmyk_444_37x29.jpg"] = ("cmyk", pillow_jpeg(rgb, "CMYK", quality=85))
    out["cmyk_pillow_420_37x29.jpg"] = ("cmyk", pillow_jpeg(rgb, "CMYK", quality=85, subsampling=2))
    out["cmyk_420_37x29.jpg"] = ("cmyk", wr.write(cm, "cmyk", samp="2x2,1x1,1x1,2x2"))
    out["cmyk_progressive_41x23.jpg"] = ("cmyk", pillow_jpeg(pattern(41, 23, 2), "CMYK",
                                                               quality=80, progressive=True))
    out["cmyk_no_adobe_37x29.jpg"] = ("cmyk", drop_segment(out["cmyk_444_37x29.jpg"][1], 0xEE,
                                                            b"Adobe"))
    out["cmyk_restart_37x29.jpg"] = ("cmyk", wr.write(cm, "cmyk", restart=3, q=90))
    cm2 = cmyk_of(pattern(33, 21, 3))
    out["ycck_444_33x21.jpg"] = ("ycck", wr.write(cm2, "ycck", q=85))
    out["ycck_420_33x21.jpg"] = ("ycck", wr.write(cm2, "ycck", samp="2x2,1x1,1x1,2x2"))
    out["ycck_progressive_33x21.jpg"] = ("ycck", wr.write(cm2, "ycck", prog=1))
    out["ycck_transform1_33x21.jpg"] = ("ycck", set_adobe_transform(out["ycck_444_33x21.jpg"][1], 1))
    # libjpeg's block smoothing: progressive streams cut by whole scans
    base = pillow_jpeg(pattern(45, 31, 4), quality=80, progressive=True, subsampling=2)
    out["smooth_last_refinement_420_45x31.jpg"] = ("smoothing", drop_scans(
        base, last_refinement(scans(base))))
    out["smooth_every_refinement_420_45x31.jpg"] = ("smoothing", drop_scans(base, lambda s: s["ah"]))
    out["smooth_dc_refinement_420_45x31.jpg"] = ("smoothing", drop_scans(
        base, lambda s: s["ss"] == 0 and s["ah"]))
    out["smooth_dc_only_420_45x31.jpg"] = ("smoothing", drop_scans(base, lambda s: s["ss"] > 0))
    base = pillow_jpeg(pattern(30, 43, 5), quality=60, progressive=True, subsampling=1,
                       restart_marker_blocks=2)
    out["smooth_restart_422_30x43.jpg"] = ("smoothing", drop_scans(base, lambda s: s["ah"]))
    base = pillow_jpeg(pattern(26, 19, 6), quality=90, progressive=True, subsampling=0)
    out["smooth_luma_ac_444_26x19.jpg"] = ("smoothing", drop_scans(
        base, lambda s: s["ss"] > 0 and s["comps"] == [1]))
    gray = pattern(35, 27, 7)[..., 1]
    base = wr.write(gray, "gray", scans=GRAY_BANDS)
    out["smooth_band_1_5_gray_35x27.jpg"] = ("smoothing", drop_scans(
        base, lambda s: s["ss"] == 1 and s["se"] == 5))
    out["smooth_band_6_63_gray_35x27.jpg"] = ("smoothing", drop_scans(base, lambda s: s["ss"] == 6))
    base = wr.write(gray, "gray", scans=GRAY_1_9)
    out["unsmoothed_band_10_63_gray_35x27.jpg"] = ("smoothing", drop_scans(
        base, lambda s: s["ss"] == 10))
    out["unsmoothed_no_dc_gray_35x27.jpg"] = ("smoothing", drop_scans(base, lambda s: s["ss"] == 0))
    base = wr.write(pattern(39, 25, 8), "ycbcr", scans=COLOUR_BANDS)
    out["unsmoothed_dc_unrefined_39x25.jpg"] = ("smoothing", drop_scans(
        base, lambda s: s["ss"] == 0 and s["ah"]))
    out["smooth_band_1_5_luma_39x25.jpg"] = ("smoothing", drop_scans(
        base, lambda s: s["comps"] == [1] and s["ss"] == 1 and s["se"] == 5))
    base = wr.write(pattern(27, 37, 9)[..., 0], "gray", prog=1, samp="2x2")
    out["smooth_gray_v2_27x37.jpg"] = ("smoothing", drop_scans(base, lambda s: s["ah"]))
    out["smooth_cmyk_41x23.jpg"] = ("smoothing", drop_scans(
        out["cmyk_progressive_41x23.jpg"][1], lambda s: s["ah"]))
    base = wr.write(pattern(37, 29, 10), "ycbcr", arith=1, prog=1)
    out["smooth_arith_37x29.jpg"] = ("smoothing", drop_scans(base, lambda s: s["ah"]))
    # lossless: libjpeg-turbo 3's writes (RGB or CMYK or gray at 1x1, each
    # predictor, point transforms, restarts), then subsampled frames from
    # the writer above
    lrgb = pattern(29, 19, 11, noise=3)
    for psv in range(1, 8):
        out[f"lossless_p{psv}_29x19.jpg"] = ("lossless", wr.write(lrgb, "rgb", lossless=f"{psv},0"))
    out["lossless_p6_pt2_29x19.jpg"] = ("lossless", wr.write(lrgb, "rgb", lossless="6,2"))
    out["lossless_gray_p4_pt1_31x17.jpg"] = ("lossless", wr.write(pattern(31, 17, 12)[..., 2],
                                                                   "gray", lossless="4,1"))
    out["lossless_restart_p7_29x19.jpg"] = ("lossless", wr.write(lrgb, "rgb", lossless="7,0",
                                                                  restart_rows=2))
    out["lossless_cmyk_p2_29x19.jpg"] = ("lossless", wr.write(cmyk_of(lrgb), "cmyk", lossless="2,0"))
    for name, hv, psv, pt in (("420_p1", [(2, 2), (1, 1), (1, 1)], 1, 0),
                              ("422_p5_pt1", [(2, 1), (1, 1), (1, 1)], 5, 1),
                              ("mixed_p7", [(1, 2), (2, 2), (1, 1)], 7, 0)):
        out[f"lossless_rgb_{name}_29x19.jpg"] = ("lossless", sof3(subsampled(lrgb, hv), hv, 29, 19,
                                                                  psv, pt))
    hv4 = [(2, 2), (1, 1), (1, 1), (2, 2)]
    out["lossless_cmyk_420_p4_29x19.jpg"] = ("lossless", sof3(
        subsampled(cmyk_of(lrgb), hv4), hv4, 29, 19, 4, ids=b"CMYK"))
    # arithmetic coding
    argb = pattern(37, 29, 13)
    out["arith_seq_420_37x29.jpg"] = ("arith", wr.write(argb, "ycbcr", arith=1))
    out["arith_seq_444_37x29.jpg"] = ("arith", wr.write(argb, "ycbcr", arith=1, q=90,
                                                        samp="1x1,1x1,1x1"))
    out["arith_seq_gray_37x29.jpg"] = ("arith", wr.write(argb[..., 1], "gray", arith=1))
    out["arith_seq_restart_37x29.jpg"] = ("arith", wr.write(argb, "ycbcr", arith=1, restart=3))
    out["arith_seq_dac_37x29.jpg"] = ("arith", wr.write(argb, "ycbcr", arith=1, dac="1,4,10"))
    out["arith_seq_no_dac_37x29.jpg"] = ("arith", drop_segment(
        out["arith_seq_420_37x29.jpg"][1], 0xCC))
    out["arith_seq_scans_37x29.jpg"] = ("arith", wr.write(
        argb, "ycbcr", arith=1, scans="0:0-63:0:0;1:0-63:0:0;2:0-63:0:0"))
    out["arith_seq_cmyk_37x29.jpg"] = ("arith", wr.write(cmyk_of(argb), "cmyk", arith=1))
    out["arith_prog_420_37x29.jpg"] = ("arith", wr.write(argb, "ycbcr", arith=1, prog=1))
    out["arith_prog_restart_37x29.jpg"] = ("arith", wr.write(argb, "ycbcr", arith=1, prog=1,
                                                             restart=2))
    out["arith_prog_gray_37x29.jpg"] = ("arith", wr.write(argb[..., 2], "gray", arith=1, prog=1))
    # what stays refused: Pillow (or libjpeg under it) refuses these too
    out["refused_12bit.jpg"] = ("refused", set_precision(out["arith_seq_420_37x29.jpg"][1], 12))
    out["refused_sof11_lossless_arith.jpg"] = ("refused", set_marker(
        out["lossless_p1_29x19.jpg"][1], 0xC3, 0xCB))
    out["refused_sof5_hierarchical.jpg"] = ("refused", set_marker(
        pillow_jpeg(argb, quality=75), 0xC0, 0xC5))
    out["refused_lossless_restart.jpg"] = ("refused", set_restart_interval(
        out["lossless_restart_p7_29x19.jpg"][1], 7))
    # libjpeg-turbo 3 converts no colour of a lossless frame
    out["refused_lossless_ycbcr.jpg"] = ("refused", set_adobe_transform(
        out["lossless_p1_29x19.jpg"][1], 1))
    out["refused_lossless_ycck.jpg"] = ("refused", set_adobe_transform(
        out["lossless_cmyk_p2_29x19.jpg"][1], 2))
    # phase 4zb: each form at 1920x1080, and a baseline 4:2:0 JPEG beside them
    big = pattern_1080()
    big_cm = np.asarray(Image.fromarray(big).convert("CMYK"))
    out["p1080_baseline_420.jpg"] = ("baseline", pillow_jpeg(big, quality=75, subsampling=2))
    out["p1080_cmyk.jpg"] = ("cmyk", pillow_jpeg(big, "CMYK", quality=75))
    out["p1080_ycck.jpg"] = ("ycck", wr.write(big_cm, "ycck", samp="2x2,1x1,1x1,2x2"))
    base = pillow_jpeg(big, quality=75, progressive=True, subsampling=2)
    out["p1080_smoothed.jpg"] = ("smoothing", drop_scans(base, lambda s: s["ah"]))
    out["p1080_lossless.jpg"] = ("lossless", wr.write(big, "rgb", lossless="4,0"))
    out["p1080_arith_seq.jpg"] = ("arith", wr.write(big, "ycbcr", arith=1))
    out["p1080_arith_prog.jpg"] = ("arith", wr.write(big, "ycbcr", arith=1, prog=1))
    return out


def _outcome(fn) -> str:
    """"read", or the class name of what ``fn`` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is the answer
        return type(e).__name__
    return "read"


def truth(form: str, data: bytes, tmp: str) -> dict:
    """The manifest entry of one file: the reference's answers."""
    from PIL import Image

    from rustcv_tpu import imgcodecs
    from rustcv_tpu.core.mat import Mat
    from rustcv_tpu.ops import decode

    path = os.path.join(tmp, "f.jpg")
    with open(path, "wb") as f:
        f.write(data)
    entry = {"form": form, "bytes": len(data), "sha256": hashlib.sha256(data).hexdigest()}
    entry["entry"] = {
        "imread": _outcome(lambda: imgcodecs.imread(path)),
        "decode_mjpeg_host_rgb": _outcome(lambda: decode.decode_mjpeg_host_rgb(data)),
        "decode_mjpeg_into_mat": _outcome(lambda: decode.decode_mjpeg_into_mat(data, Mat())),
    }
    if entry["entry"]["imread"] == "read":
        bgr = np.ascontiguousarray(np.asarray(Image.open(path).convert("RGB"))[..., ::-1])
        entry["shape"] = list(bgr.shape)
        entry["bgr_sha256"] = hashlib.sha256(bgr.tobytes()).hexdigest()
        entry["metadata"] = imgcodecs.imread_with_metadata(path)[1]
    return entry


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    os.makedirs(args.out, exist_ok=True)
    for old in glob.glob(os.path.join(args.out, "*.jpg")):
        os.remove(old)
    manifest = {}
    with tempfile.TemporaryDirectory() as tmp:
        files = fixtures(Writers(tmp))
        for name, (form, data) in sorted(files.items()):
            with open(os.path.join(args.out, name), "wb") as f:
                f.write(data)
            manifest[name] = truth(form, data, tmp)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(p) for p in glob.glob(os.path.join(args.out, "*")))
    print(f"make_jpeg_data: {len(manifest)} files and manifest.json, {total} bytes in {args.out}")


if __name__ == "__main__":
    main()
