"""The port's host JPEG coder (``rustcv_tpu_torch.native``, its own copy of
the C++ sources, built with g++ into ``build/rustcv_tpu_torch/``) against
the reference's ``rustcv_tpu.native``: for seeded quantized coefficients
both write byte-identical JFIF, from dense grids and from block-packed
rows, and each payload entropy-decodes back to the coefficients and
tables exactly (Huffman coding is lossless)."""

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
