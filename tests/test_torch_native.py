"""The port's host JPEG coder (``rustcv_tpu_torch.native``, its own copy of
the C++ sources, built with g++ into ``build/rustcv_tpu_torch/``) against
the reference's ``rustcv_tpu.native``: for seeded quantized coefficients
both write byte-identical JFIF, from dense grids and from block-packed
rows, and each payload entropy-decodes back to the coefficients and
tables exactly (Huffman coding is lossless). The union-find of the
components (``unionfind.cpp``: ``ccl_label``, ``union_find``) equals the
reference's on seeded masks and edge lists, and a library that does not
build raises with the compiler's output, where the reference's ``ccl``
falls back to Python."""

import numpy as np
import pytest

from rustcv_tpu import native as ref
from rustcv_tpu_torch import native
from rustcv_tpu_torch.ops import jpeg_encode as TE

# (width, height, subsampling)
GEOMETRIES = [(64, 48, "4:2:0"), (96, 64, "4:2:2"), (40, 24, "4:4:4"), (130, 50, "4:2:0"),
              (8, 8, "4:4:4"), (17, 9, "4:2:0")]


def _coeffs(g: dict, seed: int, scale: int):
    """Seeded sparse coefficients, grids [bh, bw, 64] per component."""
    rng = np.random.default_rng(seed)
    grids = []
    for bh, bw in g["blocks"]:
        c = rng.integers(-scale, scale + 1, (bh, bw, 64)).astype(np.int16)
        c[rng.random((bh, bw, 64)) < 0.8] = 0  # most coefficients are 0
        c[..., 0] = rng.integers(-1024, 1024, (bh, bw))  # DC anywhere in range
        grids.append(c)
    return grids


@pytest.fixture(scope="module")
def coders():
    assert native.available(), native.build_error()
    if not ref.available():
        pytest.skip(f"the reference's native library is unavailable: {ref.build_error()}")
    return native, ref


def test_build_goes_to_the_ports_build_dir():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    path = native.build_info["path"]
    assert "build/rustcv_tpu_torch/librustcv_coder_" in path and "rustcv_tpu/native" not in path


@pytest.mark.parametrize("quality", [50, 85])
@pytest.mark.parametrize("w,h,sub", GEOMETRIES)
def test_dense_payloads_are_the_references_bytes(coders, w, h, sub, quality):
    g = TE._geometry(w, h, sub)
    qy, qc = TE.quant_tables(quality)
    for seed, scale in ((w * h, 40), (quality, 1023)):
        grids = _coeffs(g, seed, scale)
        args = ([qy, qc, qc], w, h, g["h_samp"], g["v_samp"])
        got = native.jpeg_entropy_encode(grids, *args)
        assert got == ref.jpeg_entropy_encode(grids, *args)
        info, dec, qts = native.jpeg_entropy_decode(got)
        assert (info["width"], info["height"], info["ncomp"]) == (w, h, 3)
        for c in range(3):
            np.testing.assert_array_equal(dec[c].reshape(grids[c].shape), grids[c])
            np.testing.assert_array_equal(qts[c].reshape(-1), (qy, qc, qc)[c])


@pytest.mark.parametrize("k,cap", [(10, 64), (4, 400), (64, 1)])
@pytest.mark.parametrize("w,h,sub", GEOMETRIES[:3])
def test_packed_payloads_are_the_references_bytes(coders, w, h, sub, k, cap):
    import torch

    g = TE._geometry(w, h, sub)
    qy, qc = TE.quant_tables(85)
    grids = _coeffs(g, w + k, 60)
    allc = torch.from_numpy(np.concatenate([c.reshape(-1, 64) for c in grids]))[None]
    idx, val, ids, rows, nd = (a[0].numpy() for a in TE.pack_coeff_rows(allc, k, cap))
    args = (g["blocks"], [qy, qc, qc], w, h, g["h_samp"], g["v_samp"])
    if int(nd) > cap:  # over capacity: the packed rows miss blocks, only the bytes compare
        assert native.jpeg_entropy_encode_packed(idx, val, ids, rows, *args) == \
            ref.jpeg_entropy_encode_packed(idx, val, ids, rows, *args)
        return
    got = native.jpeg_entropy_encode_packed(idx, val, ids, rows, *args)
    assert got == ref.jpeg_entropy_encode_packed(idx, val, ids, rows, *args)
    assert got == native.jpeg_entropy_encode(grids, [qy, qc, qc], w, h, g["h_samp"], g["v_samp"])
    _, dec, _ = native.jpeg_entropy_decode(got)
    for c in range(3):
        np.testing.assert_array_equal(dec[c].reshape(grids[c].shape), grids[c])


@pytest.mark.parametrize("w,h", [(64, 48), (33, 17)])
def test_gray_payloads_are_the_references_bytes(coders, w, h):
    g = TE._geometry(w, h, "4:4:4")
    qy, _ = TE.quant_tables(60)
    grid = _coeffs(g, w, 30)[:1]
    got = native.jpeg_entropy_encode(grid, [qy], w, h, [1], [1])
    assert got == ref.jpeg_entropy_encode(grid, [qy], w, h, [1], [1])
    info, dec, qts = native.jpeg_entropy_decode(got)
    assert info["ncomp"] == 1
    np.testing.assert_array_equal(dec[0].reshape(grid[0].shape), grid[0])


def test_bad_input_raises(coders):
    with pytest.raises(ValueError):
        native.jpeg_entropy_decode(b"not a jpeg")
    g = TE._geometry(16, 16, "4:4:4")
    qy, qc = TE.quant_tables(85)
    with pytest.raises(ValueError, match="ncomp"):
        native.jpeg_entropy_encode(_coeffs(g, 0, 5)[:2], [qy, qc], 16, 16, [1, 1], [1, 1])
    with pytest.raises(ValueError, match="total blocks"):
        native.jpeg_entropy_encode_packed(np.zeros((3, 4), np.uint8), np.zeros((3, 4), np.int16),
                                          np.zeros(1, np.int32), np.zeros((1, 64), np.int16),
                                          g["blocks"], [qy, qc, qc], 16, 16, [1] * 3, [1] * 3)


def _ccl_masks():
    rng = np.random.default_rng(21)
    masks = {"empty": np.zeros((9, 13), np.uint8), "full": np.ones((9, 13), np.uint8) * 255,
             "one_row": (rng.random((1, 40)) < 0.5).astype(np.uint8),
             "one_col": (rng.random((40, 1)) < 0.5).astype(np.uint8)}
    for d in (0.05, 0.45, 0.6, 0.9):  # sparse and dense speckle
        masks[f"speckle{d}"] = (rng.random((57, 71)) < d).astype(np.uint8) * 7
    stripes = np.zeros((30, 30), np.uint8)
    stripes[:, ::2] = 1
    stripes[::7] = 1
    masks["stripes"] = stripes
    masks["checker"] = (np.indices((16, 16)).sum(0) % 2).astype(np.uint8)
    return masks


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("name", sorted(_ccl_masks()))
def test_ccl_label_is_the_references(coders, name, conn):
    m = _ccl_masks()[name]
    n, lab = native.ccl_label(m, conn)
    rn, rlab = ref.ccl_label(m, conn)
    assert n == rn and lab.dtype == np.int32 and np.array_equal(lab, rlab)
    if name == "checker":
        assert n == (128 if conn == 4 else 1)
    if name in ("empty", "full"):
        assert n == (0 if name == "empty" else 1)


def test_union_find_is_the_references(coders):
    rng = np.random.default_rng(22)
    for n, m in ((1, 0), (10, 0), (50, 30), (400, 900)):
        ea = rng.integers(0, n, m).astype(np.int32)
        eb = rng.integers(0, n, m).astype(np.int32)
        cnt, root = native.union_find(n, ea, eb)
        rcnt, rroot = ref.union_find(n, ea, eb)
        assert cnt == rcnt and np.array_equal(root, rroot)
        assert (root <= np.arange(n)).all()  # min-root: each root the smallest id
    with pytest.raises(ValueError, match="out of range"):
        native.union_find(3, np.array([0, 5]), np.array([1, 2]))
    with pytest.raises(ValueError, match="equal"):
        native.union_find(3, np.array([0]), np.array([1, 2]))
    with pytest.raises(ValueError, match="connectivity"):
        native.ccl_label(np.ones((2, 2), np.uint8), 6)


def test_a_library_that_does_not_build_raises(monkeypatch, tmp_path):
    """A source g++ refuses leaves no library: the components raise with
    the compiler's output, and no Python fallback labels anything."""
    from rustcv_tpu_torch.ops import ccl

    broken = tmp_path / "unionfind.cpp"
    broken.write_text("extern \"C\" long rcv_union_find( { not C++ }\n")
    monkeypatch.setattr(native, "SOURCES", (broken,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert not native.available()
    assert "g++ failed" in native.build_error()
    for call in (lambda: native.ccl_label(np.ones((3, 3), np.uint8)),
                 lambda: native.union_find(2, np.array([0]), np.array([1])),
                 lambda: ccl.connected_components(np.ones((3, 3), np.uint8)),
                 lambda: ccl.find_contours(np.ones((3, 3), np.uint8))):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            call()
