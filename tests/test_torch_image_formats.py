"""The formats the port reads without Pillow (ROADMAP Queue 1 item 8a) on
the CPU against Pillow 12, which the JAX package's ``imread``/``imdecode``
reach (``Image.open(...).convert("RGB")``, flipped to BGR), and against the
JAX package's metadata calls.

* JPEG: progressive streams (Pillow's ``progressive=True`` at each
  sampling, odd sizes, restart markers, gray), sequential streams cut into
  one scan per component, 4:4:0, 4:1:1, 4:1:0 and mixed-chroma streams
  (written by the port's own entropy coder from numpy FDCT coefficients,
  ``chip_smoke.jpeg_textured``: Pillow writes only 1x1, 2x1 and 2x2),
  libjpeg's RGB colour space;
  ``ops.decode.decode_mjpeg_host_rgb`` against the reference's. A
  progressive stream left unrefined reads as Pillow smooths it, CMYK and
  arithmetic-coded frames as Pillow reads them (the forms of item 8d-ii-b,
  held in full in ``tests/test_torch_jpeg_forms.py``); the hybrid path
  keeps refusing what it refused.
* PNG at 1, 2, 4, 8 and 16 bits in every colour type, plain and Adam7;
  BMP in every header, depth, bit-field layout and RLE form Pillow reads;
  PNM P1-P6 at maxvals 1, 100, 255, 1000 and 65535, and PFM. What Pillow
  refuses raises ``CameraError``.
* Metadata: ``imread_with_metadata`` and ``cv2.imdecodeWithMetadata`` give
  the reference's dicts and lists, in order; ``cv2.imencodeWithMetadata``
  writes what the reference's decode reads back.

The tolerance is 0 everywhere but the JPEG writes of
``imencodeWithMetadata``, held to ``imencode``'s bar (PSNR at most 0.5 dB
below Pillow's own encode). Inputs are made from seeds; sizes are small
and odd (23x17, 1x40, 130x9)."""

import io
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image, PngImagePlugin

import chip_smoke as S
from rustcv_tpu import imgcodecs as jax_codecs
from rustcv_tpu.cv2 import _extras as R2
from rustcv_tpu.ops.decode import decode_mjpeg_host_rgb as ref_rgb
from rustcv_tpu_torch import core, imgcodecs, native
from rustcv_tpu_torch.cv2 import _extras as P2
from rustcv_tpu_torch.imgcodecs import exif, host
from rustcv_tpu_torch.ops import decode

SIZES = [(23, 17), (1, 40), (130, 9)]  # (w, h)


def _pillow(data):
    """The reference's read of these bytes: RGB → BGR."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))[..., ::-1]


def _same(data):
    """imdecode and imread equal Pillow's read, byte for byte."""
    want = _pillow(data)
    got = imgcodecs.imdecode(data, device="cpu").to_numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    return want


def _both_refuse(data, tmp_path=None):
    with pytest.raises(Exception):
        _pillow(data)
    with pytest.raises(core.CameraError):
        imgcodecs.imdecode(data, device="cpu")


def _smooth(h, w, seed):
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    base = 127 + 90 * np.sin(xx / (5.0 + seed % 7))[..., None] * np.cos(yy / 7.0)[..., None]
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


# -- JPEG -------------------------------------------------------------------------


def _pillow_jpeg(bgr, **kw):
    buf = io.BytesIO()
    img = Image.fromarray(bgr[..., ::-1])
    if kw.pop("gray", False):
        img = img.convert("L")
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _segments(data):
    """[(marker, body)] up to the first SOS (included), and the rest."""
    p, out = 2, []
    while True:
        m, n = data[p + 1], struct.unpack(">H", data[p + 2:p + 4])[0]
        out.append((m, data[p + 4:p + 2 + n]))
        p += 2 + n
        if m == 0xDA:
            return out, data[p:]


def _segment(m, body):
    return b"\xff" + bytes([m]) + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sub", [0, 1, 2, "gray"])
@pytest.mark.parametrize("w,h", SIZES + [(64, 48), (3, 2)])
def test_progressive_jpeg_is_libjpegs(w, h, sub, restart):
    bgr = _smooth(h, w, w + h)
    for quality in (50, 90):
        kw = {"quality": quality, "progressive": True}
        if sub == "gray":
            kw["gray"] = True
        else:
            kw["subsampling"] = sub
        if restart:
            kw["restart_marker_blocks"] = restart
        data = _pillow_jpeg(bgr, **kw)
        want = _same(data)
        np.testing.assert_array_equal(native.jpeg_decode_bgr(data), want)
        np.testing.assert_array_equal(decode.decode_mjpeg_host_rgb(data), ref_rgb(data))
        assert decode.mjpeg_size(data) == (w, h)


def _scans(data):
    """The SOS segments of a progressive stream: [(start, end, Ss, Se, Ah)]."""
    out, p = [], 2
    while p < len(data):
        m = data[p + 1]
        if m == 0xD9:
            break
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        if m != 0xDA:
            p += 2 + n
            continue
        ns = data[p + 4]
        b = p + 5 + 2 * ns
        q = p + 2 + n
        while not (data[q] == 0xFF and data[q + 1] not in (0x00, *range(0xD0, 0xD8))):
            q += 1
        out.append((p, q, data[b], data[b + 1], data[b + 2] >> 4))
        p = q
    return out


@pytest.mark.parametrize("cut", ["last refinement", "every refinement", "DC refinement"])
def test_unrefined_progressive_jpeg_raises_not_ported(cut):
    """A progressive stream whose last bits never came: Pillow smooths its
    blocks (libjpeg's block smoothing), and the port reads it as Pillow
    does, byte for byte (ROADMAP Queue 1 item 8d-ii-b; before it, the port
    raised ``not_ported`` here)."""
    data = _pillow_jpeg(_smooth(40, 56, 3), quality=80, progressive=True)
    scans = _scans(data)
    drop = {"last refinement": [s for s in scans if s[4]][-1:],
            "every refinement": [s for s in scans if s[4]],
            "DC refinement": [s for s in scans if s[2] == 0 and s[4]]}[cut]
    assert drop
    cut_data = data
    for start, end, *_ in sorted(drop, reverse=True):
        cut_data = cut_data[:start] + cut_data[end:]
    want = _pillow(cut_data)
    np.testing.assert_array_equal(native.jpeg_decode_bgr(cut_data), want)
    np.testing.assert_array_equal(imgcodecs.imdecode(cut_data, device="cpu").to_numpy(), want)
    np.testing.assert_array_equal(decode.decode_mjpeg_host_rgb(cut_data), ref_rgb(cut_data))


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 0, 1)])
@pytest.mark.parametrize("sub", [0, 1, 2])
@pytest.mark.parametrize("w,h", SIZES + [(64, 48)])
def test_non_interleaved_jpeg_is_libjpegs(w, h, sub, order):
    base = _pillow_jpeg(_smooth(h, w, 5), quality=85, subsampling=sub)
    data = S.jpeg_one_scan_per_component(base, order)
    want = _same(data)
    np.testing.assert_array_equal(want, _pillow(base))  # the same image, cut otherwise
    with pytest.raises(ValueError):  # the hybrid path's decoder refuses it, as before
        native.jpeg_entropy_decode(data)


SAMPLINGS = {  # name: (h factors, v factors) of Y, Cb, Cr
    "4:4:0": ((1, 1, 1), (2, 1, 1)), "4:1:1": ((4, 1, 1), (1, 1, 1)),
    "4:1:0": ((4, 1, 1), (2, 1, 1)), "mixed 2x2/1x1/2x1": ((2, 1, 2), (2, 1, 1)),
    "mixed 2x2/1x2/2x1": ((2, 1, 2), (2, 2, 1)), "chroma 2x2 over luma 1x1": ((1, 2, 2), (1, 2, 2)),
    "3:1:1": ((3, 1, 1), (1, 1, 1)), "chroma 2x1 under luma 4x1": ((4, 2, 2), (1, 1, 1)),
    "luma 1x2, chroma 2x1": ((1, 2, 2), (2, 1, 1)), "every 2x1": ((2, 2, 2), (1, 1, 1)),
}


@pytest.mark.parametrize("w,h", SIZES + [(64, 48), (3, 2), (5, 37)])
@pytest.mark.parametrize("name", sorted(SAMPLINGS))
def test_every_integral_sampling_is_libjpegs(name, w, h):
    hs, vs = SAMPLINGS[name]
    data = S.jpeg_textured(w, h, hs, vs, w * h)
    np.testing.assert_array_equal(native.jpeg_decode_bgr(data), _same(data))


def test_fractional_sampling_and_large_mcus_are_refused_as_libjpeg_refuses():
    """3:2 ratios, and MCUs of more than 10 blocks (4x4 + 1 + 1, 4x2 +
    2x1 + 2x1)."""
    for hs, vs in [((3, 2, 1), (1, 1, 1)), ((4, 4, 1), (4, 1, 1)), ((4, 2, 2), (2, 1, 1))]:
        _both_refuse(S.jpeg_textured(24, 16, hs, vs, 1))


def test_rgb_colour_space_jpeg_is_libjpegs():
    """No JFIF marker and Adobe's transform 0: libjpeg takes the components
    as R, G, B, with no colour conversion."""
    bgr = _smooth(17, 23, 2)
    for kw in ({"keep_rgb": True}, {"keep_rgb": True, "subsampling": 0, "progressive": True}):
        data = _pillow_jpeg(bgr, quality=90, **kw)
        assert b"Adobe" in data
        _same(data)


def test_jpeg_forms_left_for_later_raise_not_ported():
    """CMYK, arithmetic-coded and lossless frames: the port answers as
    Pillow (ROADMAP Queue 1 item 8d-ii-b; before it, the port raised
    ``not_ported``): Pillow's CMYK and a baseline stream relabelled SOF9
    (arithmetic-coded) read byte for byte as Pillow reads them; the stream
    relabelled SOF3 (lossless, in YCbCr) Pillow refuses, and the port
    raises CameraError."""
    cmyk = io.BytesIO()
    Image.fromarray(_smooth(16, 16, 1)).convert("CMYK").save(cmyk, "JPEG")
    base = _pillow_jpeg(_smooth(16, 16, 1), quality=90)
    arith = base.replace(b"\xff\xc0", b"\xff\xc9", 1)
    lossless = base.replace(b"\xff\xc0", b"\xff\xc3", 1)
    for data in (cmyk.getvalue(), arith):
        _same(data)
    _both_refuse(lossless)


def test_the_hybrid_path_keeps_refusing_progressive_streams():
    data = _pillow_jpeg(_smooth(16, 24, 1), quality=80, progressive=True)
    for call in (native.jpeg_entropy_decode, native.jpeg_entropy_info,
                 lambda d: native.jpeg_entropy_decode_blockpacked(d, 4, 8),
                 lambda d: native.jpeg_entropy_decode_packed(d, 1024)):
        with pytest.raises(ValueError):
            call(data)
    with pytest.raises(ValueError):
        imgcodecs.imdecode(data, backend="tpu", device="cpu")


def test_decode_mjpeg_host_rgb_is_the_references(jax_cpu):
    from rustcv_tpu.core.errors import DecodeError as RefDecodeError

    for sub in (0, 1, 2):
        data = _pillow_jpeg(_smooth(17, 23, sub), quality=75, subsampling=sub)
        got = decode.decode_mjpeg_host_rgb(np.frombuffer(data, np.uint8))
        np.testing.assert_array_equal(got, ref_rgb(data))
        assert got.flags.c_contiguous
    for junk in (b"\xff\xd8\xff\xe0 not a jpeg", b"\xff\xd8"):
        with pytest.raises(RefDecodeError, match="JPEG decompress"):
            ref_rgb(junk)
        with pytest.raises(core.DecodeError, match="JPEG decompress"):
            decode.decode_mjpeg_host_rgb(junk)


# -- PNG ----------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _rows(s, depth, filt):
    """Samples (n, w, ch) → filtered PNG rows at ``depth`` (filter 0 or 1, Sub)."""
    n, w, ch = s.shape
    if depth == 16:
        raw = [r.astype(">u2").tobytes() for r in s.reshape(n, w * ch)]
    elif depth == 8:
        raw = [r.astype(np.uint8).tobytes() for r in s.reshape(n, w * ch)]
    else:
        per = 8 // depth
        raw = []
        for r in s.reshape(n, w):
            pad = np.zeros(-(-w // per) * per, np.uint8)
            pad[:w] = r
            shifts = np.arange(8 - depth, -1, -depth)
            raw.append(np.bitwise_or.reduce(pad.reshape(-1, per) << shifts, axis=1).astype(np.uint8)
                       .tobytes())
    bpp = max(1, depth * ch // 8)
    out = []
    for r in raw:
        if filt:
            a = np.frombuffer(r, np.uint8).astype(np.int16)
            prev = np.concatenate([np.zeros(bpp, np.int16), a[:-bpp]])
            r = ((a - prev) % 256).astype(np.uint8).tobytes()
        out.append(bytes([filt]) + r)
    return out


def _png(s, depth, ctype, interlace=False, plte=None, extra=b""):
    h, w, _ = s.shape
    if interlace:
        rows = [r for i, (x0, y0, dx, dy) in enumerate(_ADAM7) if s[y0::dy, x0::dx].size
                for r in _rows(s[y0::dy, x0::dx], depth, i % 2)]
    else:
        rows = _rows(s, depth, 1)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))]
    if plte is not None:
        out.append(_chunk(b"PLTE", plte))
    out += [extra, _chunk(b"IDAT", zlib.compress(b"".join(rows))), _chunk(b"IEND", b"")]
    return b"".join(out)


PNG_FORMS = [(ctype, depth) for ctype, depths in
             {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}.items()
             for depth in depths]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", PNG_FORMS)
def test_png_every_depth_and_colour_type(ctype, depth, interlace):
    rng = np.random.default_rng(ctype * 100 + depth)
    for w, h in SIZES + [(1, 1), (5, 3)]:
        top = (1 << depth) - 1
        s = rng.integers(0, top + 1, (h, w, _CHANNELS[ctype]))
        if depth == 16:  # Pillow's clip of 16-bit gray and the other types' high byte
            s.reshape(-1)[:4] = [256, 1000, 65535, 0x1234][:s.size]
        # a palette shorter than the indices: Pillow reads past it as black
        plte = bytes(rng.integers(0, 256, 3 * max(1, (top + 1) // 2)).astype(np.uint8)) \
            if ctype == 3 else None
        _same(_png(s, depth, ctype, interlace, plte))


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "LA", "I;16"])
def test_png_modes_pillow_writes_plain_and_adam7(mode, interlace):
    rng = np.random.default_rng(7)
    for w, h in SIZES:
        if mode == "I;16":
            img = Image.frombytes("I;16", (w, h), rng.integers(0, 65536, (h, w)).astype("<u2").tobytes())
        else:
            img = Image.fromarray(rng.integers(0, 256, (h, w, 4), np.uint8), "RGBA").convert(mode)
        for bits in ((1, 2, 4, 8) if mode == "P" else (None,)):
            buf = io.BytesIO()
            kw = {"interlace": 1} if interlace else {}
            if bits:
                img.quantize(1 << bits).save(buf, "PNG", bits=bits, **kw)
            else:
                img.save(buf, "PNG", **kw)
            _same(buf.getvalue())


def test_png_refusals():
    s = np.zeros((2, 2, 1), np.int64)
    bad_depth = _png(s, 8, 0).replace(b"IHDR" + struct.pack(">IIBB", 2, 2, 8, 0),
                                      b"IHDR" + struct.pack(">IIBB", 2, 2, 3, 0))
    for data in (_png(s, 8, 3),  # a palette image without PLTE
                 _png(s, 8, 0)[:60], bad_depth):
        with pytest.raises(core.CameraError):
            imgcodecs.imdecode(data, device="cpu")
    with pytest.raises(Exception):
        _pillow(bad_depth)


# -- BMP ----------------------------------------------------------------------


def _bmp(w, h, bits, rows, hsize=40, comp=0, palette=b"", colors=0, masks=None, top_down=False):
    if hsize == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hdr = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bits, comp, 0, 2835,
                          2835, colors, 0)
        if hsize >= 52 and masks is not None:
            hdr += struct.pack("<4I", *(list(masks) + [0] * (4 - len(masks))))[:hsize - 40]
        hdr += bytes(hsize - len(hdr))
    fields = struct.pack("<3I", *masks[:3]) if comp == 3 and hsize == 40 else b""
    body = b"".join(rows)
    off = 14 + len(hdr) + len(fields) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + hdr + fields + palette
            + body)


def _bmp_rows(a, bits, w, top_down=False):
    stride = ((w * bits + 31) >> 3) & ~3
    rows = []
    for r in (a if top_down else a[::-1]):
        b = _rows(r.reshape(1, w, 1), bits, 0)[0][1:] if bits < 8 else r.tobytes()
        rows.append(b + bytes(stride - len(b)))
    return rows


HEADERS = [12, 40, 52, 56, 64, 108, 124]


@pytest.mark.parametrize("hsize", HEADERS)
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bmp_palettes(hsize, bits):
    rng = np.random.default_rng(hsize + bits)
    n, entry = 1 << bits, 3 if hsize == 12 else 4
    for w, h in SIZES:
        for top_down in (False, True) if hsize != 12 else (False,):
            for colors in (0, max(2, n // 2)) if hsize != 12 else (0,):
                pal = bytes(rng.integers(0, 256, (colors or n) * entry).astype(np.uint8))
                idx = rng.integers(0, n, (h, w)).astype(np.uint8)  # past a short palette: black
                _same(_bmp(w, h, bits, _bmp_rows(idx, bits, w, top_down), hsize, 0, pal, colors,
                           top_down=top_down))
            # gray palettes, which Pillow reads as its 1 and L modes
            gray = b"".join(bytes([v] * 3 + [0] * (entry - 3))
                            for v in ((0, 255) if bits == 1 else range(n)))
            idx = rng.integers(0, 2 if bits == 1 else n, (h, w)).astype(np.uint8)
            data = _bmp(w, h, bits, _bmp_rows(idx, bits, w), hsize, 0, gray, 2 if bits == 1 else 0)
            if bits == 4 and w > ((w * 4 + 31) >> 3) & ~3:
                _both_refuse(data)  # Pillow's L mode over 4-bit rows: no codec for it
            else:
                _same(data)


@pytest.mark.parametrize("hsize", HEADERS)
@pytest.mark.parametrize("bits", [16, 24, 32])
def test_bmp_direct_colour(hsize, bits):
    rng = np.random.default_rng(hsize * bits)
    for w, h in SIZES:
        for top_down in (False, True) if hsize != 12 else (False,):
            a = rng.integers(0, 256, (h, w, bits // 8)).astype(np.uint8)
            _same(_bmp(w, h, bits, _bmp_rows(a, bits, w, top_down), hsize, 0, top_down=top_down))


BIT_FIELDS = [(16, (0xF800, 0x7E0, 0x1F)), (16, (0x7C00, 0x3E0, 0x1F)), (24, (0xFF0000, 0xFF00, 0xFF)),
              (32, (0xFF0000, 0xFF00, 0xFF, 0)), (32, (0xFF000000, 0xFF0000, 0xFF00, 0)),
              (32, (0xFF000000, 0xFF00, 0xFF, 0)), (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
              (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)), (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
              (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)), (32, (0, 0, 0, 0))]


@pytest.mark.parametrize("hsize", HEADERS[1:])
@pytest.mark.parametrize("bits,masks", BIT_FIELDS, ids=[f"{b}-{m}" for b, m in BIT_FIELDS])
def test_bmp_bit_fields(bits, masks, hsize):
    rng = np.random.default_rng(bits + hsize)
    for w, h in SIZES:
        a = rng.integers(0, 256, (h, w, bits // 8)).astype(np.uint8)
        data = _bmp(w, h, bits, _bmp_rows(a, bits, w), hsize, 3, masks=masks)
        # headers of 40 and 52 bytes carry no alpha mask: Pillow takes it as 0
        read = masks if hsize >= 56 or bits != 32 else masks[:3] + (0,)
        if (bits, read) in BIT_FIELDS:
            _same(data)
        else:
            _both_refuse(data)


def _rle(idx, rle4):
    """RLE8/RLE4 rows (bottom-up) of encoded runs, absolute runs (odd and
    even) and one-pixel runs, each row ended by an end of line."""
    out = bytearray()
    for r in idx[::-1].copy():
        x = 0
        while x < len(r):
            if (x // 3) % 2 == 0:
                n, a, b = min(len(r) - x, 5), int(r[x]), int(r[min(x + 1, len(r) - 1)])
                out += bytes([n, (a << 4) | b if rle4 else a])
                x += n
            elif len(r) - x >= 3:
                n = min(len(r) - x, 7)
                run = [int(v) for v in r[x:x + n]]
                body = bytes((run[2 * i] << 4) | run[2 * i + 1] for i in range(n // 2)) if rle4 \
                    else bytes(run)
                out += bytes([0, n]) + body + bytes(len(body) % 2)
                x += n
            else:
                out += bytes([1, int(r[x]) << 4 if rle4 else int(r[x])])
                x += 1
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


@pytest.mark.parametrize("rle4", [False, True])
@pytest.mark.parametrize("w,h", SIZES + [(5, 8)])
def test_bmp_rle(w, h, rle4):
    """Pillow's RLE decoder step for step: absolute runs (an odd RLE4 run
    loses its last pixel there), end of line, its delta (which reads two
    bytes more than the spec's), end of bitmap; too little data raises."""
    rng = np.random.default_rng(w + h)
    bits, comp = (4, 2) if rle4 else (8, 1)
    pal = bytes(rng.integers(0, 256, 16 * 4).astype(np.uint8))
    stream = _rle(rng.integers(0, 16, (h, w)).astype(np.uint8), rle4)
    for body in (stream, bytes([0, 2, 1, 1]) + stream, bytes([0, 2, 1, 0, 2, 0]) + stream):
        _same(_bmp(w, h, bits, [body], 40, comp, pal, 16))
    _both_refuse(_bmp(w, h, bits, [stream[:len(stream) // 3] + b"\x00\x01"], 40, comp, pal, 16))


def test_bmp_refusals():
    rows = [bytes(12)] * 4
    for data in (_bmp(4, 4, 24, rows, 40, 4),  # JPEG compression
                 _bmp(4, 4, 16, [bytes(8)] * 4, 40, 3, masks=(0xF000, 0xF00, 0xF0)),
                 _bmp(4, 4, 32, [bytes(16)] * 4, 40, 3, masks=(0xFF, 0xFF00, 0xFF0000)),
                 _bmp(4, 4, 2, [bytes(4)] * 4, 40, 0, bytes(16)),  # 2-bit
                 b"BM" + struct.pack("<IHHIIHHHH", 80, 0, 0, 30, 16, 4, 4, 1, 24) + bytes(80)):
        _both_refuse(data)


# -- PNM ----------------------------------------------------------------------

MAXVALS = [1, 100, 255, 1000, 65535]


def _pnm(magic, v, maxval, comment=True):
    h, w = v.shape[:2]
    head = magic + (b"\n# a comment\n" if comment else b"\n") + b"%d %d\n" % (w, h)
    if magic in (b"P1", b"P4"):
        if magic == b"P4":
            return head + np.packbits(v.astype(np.uint8), axis=1).tobytes()
        return head + b"\n".join(b"".join(b"%d" % x for x in r) + b"#c" for r in v)
    head += b"%d\n" % maxval
    if magic in (b"P5", b"P6"):
        return head + v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return head + b"\n".join(b" ".join(b"%d" % x for x in r) + b" # c" for r in v.reshape(h, -1))


@pytest.mark.parametrize("maxval", MAXVALS)
@pytest.mark.parametrize("magic", [b"P2", b"P3", b"P5", b"P6"])
def test_pnm_every_maxval(magic, maxval):
    """Gray above 255 is Pillow's I mode and clips (256 of 1000 → 255);
    colour scales (256 of 1000 → 65); below 255 both scale with Python's
    rounding."""
    rng = np.random.default_rng(maxval)
    ch = 3 if magic in (b"P3", b"P6") else 1
    for w, h in SIZES:
        v = rng.integers(0, maxval + 1, (h, w, ch))
        v.reshape(-1)[:2] = [maxval, min(256, maxval)]
        _same(_pnm(magic, v[..., 0] if ch == 1 else v, maxval))
    if magic in (b"P2", b"P3"):  # a sample above maxval: Pillow raises
        _both_refuse(_pnm(magic, np.full((1, 1, ch) if ch == 3 else (1, 1), maxval + 1), maxval))


@pytest.mark.parametrize("magic", [b"P1", b"P4"])
def test_pbm(magic):
    """A 1 bit is black; comments may sit in the header and between rows."""
    rng = np.random.default_rng(4)
    for w, h in SIZES:
        _same(_pnm(magic, rng.integers(0, 2, (h, w)), 1))


@pytest.mark.parametrize("endian", ["<", ">"])
def test_pfm(endian):
    """Rows bottom-up, the scale's sign gives the byte order; Pillow's F
    clips to 0-255 and truncates (NaN is 0)."""
    rng = np.random.default_rng(1)
    for w, h in SIZES:
        f = rng.normal(100, 120, (h, w)).astype(np.float32)
        f.reshape(-1)[:5] = [np.nan, np.inf, -np.inf, 254.9, -0.5][:f.size]
        scale = b"-1.0" if endian == "<" else b"2.5"
        _same(b"Pf\n%d %d\n%s\n" % (w, h, scale) + f.astype(endian + "f4").tobytes())
    _both_refuse(b"PF\n1 1\n-1.0\n" + bytes(12))  # colour PFM: Pillow has no reader


def test_pnm_refusals():
    for data in (b"P6\n4 4\n255\n\x00", b"P6\n0 4\n255\n", b"P5\n1 1\n0\n\x00",
                 b"P5\n1 1\n65536\n\x00\x00", b"P2\n1 1\n255\nx", b"P5\n12345678901 1\n255\n"):
        _both_refuse(data)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        imgcodecs.imdecode(b"PyRGBA\n1 1\n255\n" + bytes(4), device="cpu")


# -- metadata -----------------------------------------------------------------


def _exif():
    ex = Image.Exif()
    for tag, value in [(0x010F, "maker"), (0x0112, 3), (0x011A, 72.0), (0x011B, 300.5),
                       (0x0128, 2), (0x0131, "soft"), (0x013B, "artist"), (0x0102, (8, 8, 8)),
                       (700, b"<x/>"), (36864, b"0230"), (33432, "c")]:
        ex[tag] = value
    ex.get_ifd(0x8769)[36867] = "2024:01:01 00:00:00"
    ex.get_ifd(0x8825)[1] = "N"
    return ex


def _metadata_files():
    a = np.random.default_rng(0).integers(0, 256, (9, 13, 3), np.uint8)
    files = {}

    def save(name, fmt, img=None, **kw):
        buf = io.BytesIO()
        (img or Image.fromarray(a)).save(buf, fmt, **kw)
        files[name] = buf.getvalue()

    small = Image.Exif()
    small[0x010F], small[0x0112], small[0x011A], small[36864] = "maker", 3, 72.0, b"0230"
    save("jpeg exif dpi", "JPEG", exif=small, dpi=(72, 72))
    save("jpeg exif", "JPEG", exif=_exif())
    save("jpeg exif progressive", "JPEG", exif=_exif(), progressive=True)
    save("jpeg plain", "JPEG")
    save("jpeg xmp", "JPEG", xmp=b'<x tiff:Orientation="8"/>')
    save("jpeg xmp exif", "JPEG", xmp=b'<x tiff:Orientation="8"/>', exif=_exif())
    save("jpeg adobe rgb", "JPEG", keep_rgb=True)
    save("png exif", "PNG", exif=small)
    save("png big exif", "PNG", exif=_exif())
    info = PngImagePlugin.PngInfo()
    info.add_text("Title", "x")
    info.add_text("Cmt", "zz", zip=True)
    info.add_itxt("Auth", "héllo")
    info.add_itxt("XML:com.adobe.xmp", '<x tiff:Orientation="6"/>')
    save("png text", "PNG", pnginfo=info, transparency=(1, 2, 3))
    save("png gray trns adam7", "PNG", img=Image.fromarray(a[..., 0]), transparency=7, interlace=1)
    save("png palette trns", "PNG", img=Image.fromarray(a).convert("P"), transparency=3)
    plain = files["png exif"]
    raw = _exif().tobytes()
    hexed = ("\nexif\n%8d\n" % len(raw) + raw.hex()).encode()
    files["png gamma srgb"] = (plain[:33] + _chunk(b"gAMA", struct.pack(">I", 45455))
                               + _chunk(b"sRGB", b"\x00") + plain[33:])
    save("png plain", "PNG")
    files["png raw profile after the image"] = (files["png plain"][:-12] + _chunk(
        b"tEXt", b"Raw profile type exif\x00" + hexed) + files["png plain"][-12:])
    files["png raw profile"] = (files["png plain"][:33] + _chunk(
        b"tEXt", b"Raw profile type exif\x00" + hexed) + files["png plain"][33:])
    files["png exif after the image"] = (files["png plain"][:-12] + _chunk(b"eXIf", raw)
                                         + files["png plain"][-12:])
    save("bmp", "BMP")
    save("ppm", "PPM")
    files["pfm"] = b"Pf\n2 1\n-2.5\n" + np.array([1, 2], "<f4").tobytes()
    return files


METADATA_FILES = _metadata_files()


@pytest.mark.parametrize("name", sorted(METADATA_FILES))
def test_imread_with_metadata_is_the_references(name, tmp_path, jax_cpu):
    data = METADATA_FILES[name]
    path = tmp_path / "x"
    path.write_bytes(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want_mat, want = jax_codecs.imread_with_metadata(str(path))
    got_mat, got = imgcodecs.imread_with_metadata(str(path), device="cpu")
    assert list(got.items()) == list(want.items())
    assert np.array_equal(got_mat.to_numpy(), want_mat.to_numpy())
    img, keys, values = P2.imdecodeWithMetadata(np.frombuffer(data, np.uint8))
    r_img, r_keys, r_values = R2.imdecodeWithMetadata(np.frombuffer(data, np.uint8))
    assert (keys, values) == (r_keys, r_values) and np.array_equal(img, r_img)
    assert exif.metadata(data) == got and list(exif.info_metadata(data)) == keys


def test_a_pillow_written_jpegs_metadata_exactly():
    assert exif.metadata(METADATA_FILES["jpeg exif dpi"]) == {
        "jfif": "257", "jfif_unit": "1", "exif:36864": "b'0230'", "exif:274": "3",
        "exif:282": "72.0", "exif:271": "maker"}
    assert list(exif.metadata(METADATA_FILES["jpeg exif dpi"])) == [
        "jfif", "jfif_unit", "exif:36864", "exif:274", "exif:282", "exif:271"]


@pytest.mark.parametrize("ext", [".png", ".jpg", ".bmp", ".ppm"])
@pytest.mark.parametrize("gray", [False, True])
def test_imencode_with_metadata_reads_back_as_the_references(ext, gray):
    a = np.random.default_rng(1).integers(0, 256, (17, 23, 3), np.uint8)
    if ext == ".jpg":
        a = _smooth(48, 64, 2)
    if gray:
        a = a[..., 1].copy()
    md = {"Title": "x", "Author": "héllo", "Comment": "ünï ☃"}
    for types, values in ((None, md), (list(md), list(md.values())), (None, None)):
        ok, buf = P2.imencodeWithMetadata(ext, a, types, values)
        r_ok, r_buf = R2.imencodeWithMetadata(ext, a, types, values)
        assert ok is r_ok is True and buf.dtype == np.uint8
        got, want = R2.imdecodeWithMetadata(buf), R2.imdecodeWithMetadata(r_buf)
        assert got[1:] == want[1:]
        if ext != ".jpg":
            assert np.array_equal(got[0], want[0])
            continue
        # imencode's bar: PSNR at most 0.5 dB below Pillow's own encode
        ref = a if a.ndim == 3 else np.repeat(a[..., None], 3, 2)

        def psnr(x):
            return 10 * np.log10(255.0 ** 2 / np.mean((x.astype(np.float64) - ref) ** 2))

        assert psnr(got[0]) >= psnr(want[0]) - 0.5


def test_metadata_refusals(tmp_path):
    # a 16-bit gray PNG, once refused, is written (item 8d-ii-a): the reference's bytes
    u16 = np.arange(16, dtype=np.uint16).reshape(4, 4) * 4099
    ok, buf = P2.imencodeWithMetadata(".png", u16, None, {"k": "v"})
    assert ok and buf.tobytes() == R2.imencodeWithMetadata(".png", u16, None, {"k": "v"})[1].tobytes()
    # a WebP, once refused, is written (item 8c-ii; its bars: tests/test_torch_webp_write.py)
    ok, buf = P2.imencodeWithMetadata(".webp", np.zeros((4, 4, 3), np.uint8))
    assert ok and imgcodecs.imdecode(buf.tobytes(), device="cpu").to_numpy().shape == (4, 4, 3)
    with pytest.raises(core.CameraError):
        P2.imencodeWithMetadata(".xyz", np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(core.CameraError):
        P2.imdecodeWithMetadata(np.frombuffer(b"no image here at all", np.uint8))
    with pytest.raises(Exception):
        R2.imdecodeWithMetadata(np.frombuffer(b"no image here at all", np.uint8))
    path = tmp_path / "x.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(30))
    with pytest.raises(core.CameraError):
        imgcodecs.imread_with_metadata(str(path), device="cpu")


# -- chip_smoke.py's phase 3v: its writers, truths and constants ------------------


def test_smoke_constants_are_pillows(tmp_path, jax_cpu):
    """Phase 3v holds the card to constants made here: the progressive
    JPEG's decode hash, the Latin-1 masks and the PNG eXIf's metadata."""
    import hashlib

    from rustcv_tpu.ops import text as ref_text

    assert len(S.PROGRESSIVE_JPEG) <= 1024 and b"\xff\xc2" in S.PROGRESSIVE_JPEG
    bgr = np.ascontiguousarray(_pillow(S.PROGRESSIVE_JPEG))
    assert hashlib.sha256(bgr.tobytes()).hexdigest()[:16] == S.PROGRESSIVE_SHA
    for px, want in S.LATIN1_MASKS.items():
        mask, dx, dy = ref_text.rasterize(S.LATIN1_TEXT, px / 20)
        assert (hashlib.sha256(mask.tobytes()).hexdigest()[:16], mask.shape, dx, dy) == want
    path = tmp_path / "exif.png"
    path.write_bytes(S.png_exif(np.zeros((3, 5, 3), np.int64)))
    meta = jax_codecs.imread_with_metadata(str(path))[1]
    assert list(meta.items()) == list(S.PNG_EXIF_META.items())


def test_smoke_files_and_truths_are_pillows():
    """Every file phase 3v makes reads in Pillow as in the port, and its
    numpy truth (where it has one) is Pillow's read."""
    cases = S.format_cases(37, 23)
    assert len(cases) == 60
    for name, data, truth in cases:
        want = _same(data)
        if truth is not None:
            assert np.array_equal(truth, want), name


def test_smoke_phase_3v_rehearsed_on_the_cpu(monkeypatch):
    """Phase 3v itself, with the CPU for the card and small frames."""
    monkeypatch.setattr(S, "W", 320)
    monkeypatch.setattr(S, "H", 180)
    counts = S.run_formats_8a(dev="cpu", w=29, h=19)
    assert not any(counts.values())


def test_a_12_bit_jpeg_is_refused_as_pillow_refuses():
    """Pillow 12.1 cannot handle 12-bit layers: the port raises
    ``CameraError``, as the reference's ``imdecode`` does."""
    base = _pillow_jpeg(_smooth(16, 16, 1), quality=90)
    sof = base.index(b"\xff\xc0")
    twelve = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    _both_refuse(twelve)
