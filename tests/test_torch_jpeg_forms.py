"""The JPEG forms of ROADMAP Queue 1 item 8d-ii-b on the CPU, against the
reference, whose reads go through Pillow 12.1 and its libjpeg-turbo 3.1.3
(``Image.open(...).convert("RGB")``, flipped to BGR), and, for
``decode_mjpeg_into_mat``, through its own libjpeg-turbo 2.1.5 binding.

* CMYK and YCCK (Pillow reads every four-component JPEG inverted, with or
  without an Adobe marker; a transform other than 0 is YCCK);
* libjpeg's block smoothing of progressive streams left unrefined (cut by
  whole scans: the last refinement, every refinement, the DC refinement,
  whole AC bands, a component's AC), and the streams it leaves alone (only
  coefficients 10..63 unrefined, no DC);
* lossless SOF3 (each predictor, point transforms, restarts, subsampled
  frames upsampled by replication; a frame whose colour needs converting
  refused, as libjpeg-turbo 3 refuses it);
* arithmetic-coded SOF9 and SOF10 (DAC conditioning and its defaults,
  restarts, scans of one component, progressive refinements);
* what stays refused: 12-bit, hierarchical, lossless arithmetic (SOF11).

The fixtures are ``tests/data/jpeg`` (``tools/make_jpeg_data.py``); the
seeded streams are Pillow's, made here. Every entry point that reads a file
answers as the reference's: the same bytes (tolerance 0) or the same error
class. The one deviation: ``decode_mjpeg_into_mat`` reads as Pillow's
libjpeg-turbo 3.1.3 where the reference's libjpeg-turbo 2.1.5 differs: a
lossless frame, which 2.1.5 does not know, and a smoothed progressive frame
of a component with v > 1 or two blocks wide, where 2.1.5 takes other
neighbour rows and columns."""

import hashlib
import io
import json
import math
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

import rustcv_tpu_torch.cv2 as cv2
from rustcv_tpu import imgcodecs as ref_codecs
from rustcv_tpu.core.mat import Mat as RefMat
from rustcv_tpu.cv2 import _classes as R1
from rustcv_tpu.cv2 import _extras as R2
from rustcv_tpu.cv2 import _util as RU
from rustcv_tpu.ops import decode as ref_decode
from rustcv_tpu_torch import core, imgcodecs, native
from rustcv_tpu_torch.core.mat import Mat
from rustcv_tpu_torch.cv2 import _extras as P2
from rustcv_tpu_torch.ops import decode

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
with open(os.path.join(DATA, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
NAMES = sorted(MANIFEST)
READ = [n for n in NAMES if MANIFEST[n]["entry"]["imread"] == "read"]


def _data(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _pillow(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))[..., ::-1]


def _outcome(fn):
    """(``"read"``, the result) or (the class name of what ``fn`` raises, None)."""
    try:
        return "read", fn()
    except Exception as e:  # noqa: BLE001 - the class is the answer
        return type(e).__name__, None


def _port_into(data: bytes) -> np.ndarray:
    mat = Mat(device="cpu")
    decode.decode_mjpeg_into_mat(data, mat)
    return mat.to_numpy()


def _ref_into(data: bytes) -> np.ndarray:
    mat = RefMat()
    ref_decode.decode_mjpeg_into_mat(data, mat)
    return mat.to_numpy()


def _sof(data: bytes):
    """(width, [(h, v) per component]) from a stream's frame header."""
    p = 2
    while data[p + 1] not in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
        p += 2 + struct.unpack(">H", data[p + 2:p + 4])[0]
    w, nc = struct.unpack(">H", data[p + 7:p + 9])[0], data[p + 9]
    return w, [(data[p + 11 + 3 * c] >> 4, data[p + 11 + 3 * c] & 15) for c in range(nc)]


def _smoothed_otherwise_by_2_1(data: bytes) -> bool:
    """Whether libjpeg-turbo 2.1's block smoothing may differ from 3.1's
    on this frame: it takes the neighbour rows from the block row and the
    iMCU row, which differs where a component has v > 1, and repeats a
    component's first column where it is two blocks wide."""
    w, factors = _sof(data)
    hmax = max(h for h, _ in factors)
    return any(v > 1 or math.ceil(math.ceil(w * h / hmax) / 8) == 2 for h, v in factors)


# -- the fixtures ---------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_manifest_is_a_fresh_pillow_read(name):
    """The committed file and its manifest entry agree with Pillow here, so
    a stale manifest fails on the CPU and not only on the card."""
    data, m = _data(name), MANIFEST[name]
    assert hashlib.sha256(data).hexdigest() == m["sha256"] and len(data) == m["bytes"]
    outcome, bgr = _outcome(lambda: _pillow(data))
    assert (outcome == "read") == (m["entry"]["imread"] == "read")
    if bgr is not None:
        assert list(bgr.shape) == m["shape"] and _sha(bgr) == m["bgr_sha256"]


@pytest.mark.parametrize("name", NAMES)
def test_file_reads_are_the_references(name, jax_cpu):
    """imread, imdecode, imread_with_metadata and cv2's imread, imdecode,
    imdecodeWithMetadata and imreadmulti/imcount: the reference's bytes and
    metadata, or its error class."""
    path = os.path.join(DATA, name)
    data, m = _data(name), MANIFEST[name]
    outcome, ref = _outcome(lambda: ref_codecs.imread(path).to_numpy())
    assert outcome == m["entry"]["imread"]
    if ref is None:
        for call in (lambda: imgcodecs.imread(path, device="cpu"),
                     lambda: imgcodecs.imdecode(data, device="cpu"),
                     lambda: imgcodecs.imread_with_metadata(path, device="cpu"),
                     lambda: cv2.imread(path)):
            assert _outcome(call)[0] == outcome
        assert _outcome(lambda: R1.imread(path))[0] == outcome
        assert cv2.imcount(path) == RU.imcount(path)
        return
    assert _sha(ref) == m["bgr_sha256"]
    np.testing.assert_array_equal(imgcodecs.imread(path, device="cpu").to_numpy(), ref)
    np.testing.assert_array_equal(imgcodecs.imdecode(data, device="cpu").to_numpy(), ref)
    np.testing.assert_array_equal(cv2.imread(path), R1.imread(path))
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8)),
                                  R1.imdecode(np.frombuffer(data, np.uint8)))
    mat, meta = imgcodecs.imread_with_metadata(path, device="cpu")
    np.testing.assert_array_equal(mat.to_numpy(), ref)
    assert meta == ref_codecs.imread_with_metadata(path)[1] == m["metadata"]
    img, keys, values = P2.imdecodeWithMetadata(np.frombuffer(data, np.uint8))
    r_img, r_keys, r_values = R2.imdecodeWithMetadata(np.frombuffer(data, np.uint8))
    np.testing.assert_array_equal(img, r_img)
    assert (keys, values) == (r_keys, r_values)
    ok, pages = cv2.imreadmulti(path)
    assert ok and len(pages) == 1 and cv2.imcount(path) == 1
    np.testing.assert_array_equal(pages[0], ref)


@pytest.mark.parametrize("name", NAMES)
def test_mjpeg_decodes_are_the_references(name, jax_cpu):
    """decode_mjpeg_host_rgb (Pillow) and decode_mjpeg_into_mat (the
    reference's libjpeg BGR binding: DecodeError for CMYK and YCCK). Where
    that binding's libjpeg-turbo 2.1.5 differs from Pillow's 3.1.3 (a
    lossless frame it does not know; a smoothed frame's neighbour blocks),
    the port reads as Pillow does (the port map's DEVIATIONS)."""
    data, m = _data(name), MANIFEST[name]
    for entry, port, ref in (("decode_mjpeg_host_rgb", decode.decode_mjpeg_host_rgb,
                              ref_decode.decode_mjpeg_host_rgb),
                             ("decode_mjpeg_into_mat", _port_into, _ref_into)):
        want, want_img = _outcome(lambda: ref(data))
        got, got_img = _outcome(lambda: port(data))
        assert want == m["entry"][entry]
        if entry == "decode_mjpeg_into_mat" and m["form"] == "lossless" and m["shape"] and \
                native.jpeg_header(data)[2] != 4:
            assert want == "DecodeError" and got == "read"
            np.testing.assert_array_equal(got_img, _pillow(data))
            continue
        assert got == want, (entry, got, want)
        if want_img is None:
            continue
        if entry == "decode_mjpeg_into_mat" and _sha(want_img) != m["bgr_sha256"]:
            assert m["form"] == "smoothing" and _smoothed_otherwise_by_2_1(data)
            want_img = _pillow(data)
        np.testing.assert_array_equal(got_img, want_img)


@pytest.mark.parametrize("name", [n for n in READ if MANIFEST[n]["form"] != "baseline"])
def test_the_hybrid_path_keeps_refusing_the_new_forms(name):
    """The hybrid decode's parse (``backend="tpu"``, the ``rcv_jpeg_coeffs``
    family) refuses four-component, lossless, arithmetic-coded and
    progressive frames, as before; the reference's hybrid decoder does too."""
    data = _data(name)
    for call in (native.jpeg_entropy_decode, native.jpeg_entropy_info,
                 lambda d: native.jpeg_entropy_decode_blockpacked(d, 4, 8),
                 lambda d: native.jpeg_entropy_decode_packed(d, 1024),
                 lambda d: imgcodecs.imdecode(d, backend="tpu", device="cpu")):
        with pytest.raises(ValueError):
            call(data)


# -- seeded streams ---------------------------------------------------------------

SIZES = [(23, 17), (1, 40), (130, 9), (64, 48)]


def _smooth(h, w, seed):
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    base = 127 + 90 * np.sin(xx / (5.0 + seed % 7))[..., None] * np.cos(yy / 7.0)[..., None]
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def _save(rgb, mode=None, **kw) -> bytes:
    im = Image.fromarray(rgb)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sub", [-1, 0, 1, 2])
@pytest.mark.parametrize("w,h", SIZES)
def test_pillow_cmyk_is_read_as_pillow_reads_it(w, h, sub, progressive, jax_cpu):
    data = _save(_smooth(h, w, w * h), "CMYK", quality=80, subsampling=sub,
                 progressive=progressive)
    want = _pillow(data)
    np.testing.assert_array_equal(native.jpeg_decode_bgr(data), want)
    np.testing.assert_array_equal(decode.decode_mjpeg_host_rgb(data), ref_decode.decode_mjpeg_host_rgb(data))
    for into in (_port_into, _ref_into):
        with pytest.raises(core.DecodeError if into is _port_into else Exception,
                           match="JPEG decompress"):
            into(data)


def _scans(data):
    """The scans of a stream: [(start, end, component ids, Ss, Se, Ah)]."""
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
        out.append((p, q, [data[p + 5 + 2 * i] for i in range(ns)], data[b], data[b + 1],
                    data[b + 2] >> 4))
        p = q
    return out


def _cut(data, pred):
    drop = [s for s in _scans(data) if pred(s)]
    for start, end, *_ in sorted(drop, reverse=True):
        data = data[:start] + data[end:]
    return data, len(drop)


# Cuts of whole scans that leave a consistent stream (no refinement of a band
# whose first pass is gone): what libjpeg's smoothing sees at EOI.
CUTS = {
    "last refinement": None,  # the stream's last scan with Ah > 0
    "every refinement": lambda s: s[5] > 0,
    "DC refinement": lambda s: s[3] == 0 and s[5] > 0,
    "AC refinements": lambda s: s[3] > 0 and s[5] > 0,
    "every AC scan": lambda s: s[3] > 0,
    "luma AC": lambda s: s[3] > 0 and s[2] == [1],
    "chroma AC": lambda s: s[3] > 0 and s[2] != [1],
    "the first DC scan only": lambda s: not (s[3] == 0 and s[5] == 0),
}


@pytest.mark.parametrize("cut,sub", [(c, s) for c in sorted(CUTS) for s in (0, 1, 2, "gray")
                                     if not (s == "gray" and c == "chroma AC")])
@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("w,h", [(23, 17), (130, 9), (41, 73)])
def test_block_smoothing_is_libjpegs(w, h, sub, restart, cut, jax_cpu):
    """Progressive streams left unrefined by whole scans: the port smooths
    where libjpeg does (DC known in every component, some coefficient 1..9
    left unrefined; the DC too where none of 1..9 came) and reads them as
    Pillow does, ``decode_mjpeg_into_mat`` too. The reference's
    libjpeg-turbo 2.1.5 binding agrees but where its neighbour blocks
    differ (the port map's DEVIATIONS)."""
    kw = {"quality": 50 + w % 40, "progressive": True}
    if sub == "gray":
        mode = "L"
    else:
        mode, kw["subsampling"] = None, sub
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _save(_smooth(h, w, w + h), mode, **kw)
    pred = CUTS[cut]
    if pred is None:
        last = [s for s in _scans(data) if s[5]][-1]
        pred = lambda s: s[0] == last[0]  # noqa: E731
    cut_data, dropped = _cut(data, pred)
    assert dropped
    want = _pillow(cut_data)
    np.testing.assert_array_equal(native.jpeg_decode_bgr(cut_data), want)
    np.testing.assert_array_equal(imgcodecs.imdecode(cut_data, device="cpu").to_numpy(), want)
    np.testing.assert_array_equal(decode.decode_mjpeg_host_rgb(cut_data),
                                  ref_decode.decode_mjpeg_host_rgb(cut_data))
    np.testing.assert_array_equal(_port_into(cut_data), want)
    if not np.array_equal(_ref_into(cut_data), want):
        assert _smoothed_otherwise_by_2_1(cut_data)


def test_cmyk_to_rgb_is_pillows():
    """The one copy of Pillow's CMYK -> RGB (the JPEG decode's and the TIFF
    reader's) against ``Image.convert`` on the 256 levels of each ink against
    every K, and on seeded pixels."""
    rng = np.random.default_rng(0)
    v = np.arange(256, dtype=np.uint8)
    grid = np.stack(np.broadcast_arrays(v[:, None], v[None, :], v[::-1, None], v[None, :]), -1)
    for px in (grid.reshape(256, 256, 4), rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)):
        want = np.asarray(Image.frombytes("CMYK", px.shape[1::-1], px.tobytes()).convert("RGB"))
        np.testing.assert_array_equal(native.cmyk_to_rgb(px), want)


@pytest.mark.parametrize("marker", [0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF])
def test_frames_libjpeg_refuses_raise_as_the_reference(marker, tmp_path, jax_cpu):
    """Hierarchical frames (SOF5-7, SOF13-15) and lossless arithmetic-coded
    ones (SOF11): Pillow's libjpeg refuses them, and both sides raise."""
    data = _data("arith_seq_420_37x29.jpg").replace(b"\xff\xc9", bytes([0xFF, marker]), 1)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    with pytest.raises(Exception):
        _pillow(data)
    with pytest.raises(core.CameraError):
        imgcodecs.imread(str(path), device="cpu")
    with pytest.raises(Exception):
        ref_codecs.imread(str(path))
    with pytest.raises(core.DecodeError):
        decode.decode_mjpeg_host_rgb(data)


def test_mjpeg_size_refuses_four_components():
    """The engine's host MJPEG staging sizes a frame with mjpeg_size: a
    CMYK frame is a stream fault (DecodeError), as in the reference's
    libjpeg BGR staging."""
    with pytest.raises(core.DecodeError, match="four-component"):
        decode.mjpeg_size(_data("cmyk_444_37x29.jpg"))
    assert decode.mjpeg_size(_data("arith_seq_420_37x29.jpg")) == (37, 29)


@pytest.mark.parametrize("name", ["lossless_p1_29x19.jpg", "lossless_restart_p7_29x19.jpg",
                                  "arith_seq_420_37x29.jpg", "arith_prog_420_37x29.jpg",
                                  "cmyk_444_37x29.jpg", "smooth_dc_only_420_45x31.jpg"])
@pytest.mark.parametrize("side", ["width", "height"])
def test_empty_frames_raise_as_the_reference(name, side, tmp_path, jax_cpu):
    """A frame header of width or height 0 (libjpeg's JERR_EMPTY_IMAGE;
    Pillow cannot identify the file): every entry point raises the
    reference's error class, lossless frames too, whose restart interval
    is measured in MCU rows."""
    data = bytearray(_data(name))
    p = 2
    while data[p + 1] not in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
        p += 2 + struct.unpack(">H", data[p + 2:p + 4])[0]
    off = p + (7 if side == "width" else 5)
    data[off:off + 2] = b"\0\0"
    data = bytes(data)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    for port, ref in ((lambda: imgcodecs.imread(str(path), device="cpu"),
                       lambda: ref_codecs.imread(str(path))),
                      (lambda: decode.decode_mjpeg_host_rgb(data),
                       lambda: ref_decode.decode_mjpeg_host_rgb(data)),
                      (lambda: _port_into(data), lambda: _ref_into(data))):
        want = _outcome(ref)[0]
        assert want in ("CameraError", "DecodeError") and _outcome(port)[0] == want


@pytest.mark.parametrize("k", [0, 64, 255])
@pytest.mark.parametrize("name", ["arith_seq_dac_37x29.jpg", "arith_prog_420_37x29.jpg"])
def test_dac_conditioning_outside_1_63_reads_as_pillow(name, k, jax_cpu):
    """libjpeg takes any AC conditioning value K from a DAC segment (it
    checks only a DC table's L <= U), so Pillow reads such a stream: the
    port reads it byte for byte as Pillow does."""
    data = _data(name)
    sos = data.index(b"\xff\xda")
    data = data[:sos] + bytes([0xFF, 0xCC, 0, 6, 16, k, 17, k]) + data[sos:]
    want = _pillow(data)
    np.testing.assert_array_equal(native.jpeg_decode_bgr(data), want)
    np.testing.assert_array_equal(imgcodecs.imdecode(data, device="cpu").to_numpy(), want)
    np.testing.assert_array_equal(decode.decode_mjpeg_host_rgb(data),
                                  ref_decode.decode_mjpeg_host_rgb(data))
