"""Phase 3t's cv2 user's script (``chip_smoke.cv2_write_read``,
``cv2_frame_calls``, ``cv2_clip_calls``, ``cv2_filestorage``) at 160×120 ×
4 frames: the reference's facade on numpy against the port's on CPU
tensors, refusing implicit numpy conversions as tensors on the card do.

Bars: equal, but for the float Harris response (the reference's own bar,
HARRIS_TOL), ORB angles (1e-3 rad) and the JPEG encodes, which are the
port's encoder's, not Pillow's (within 0.5 dB PSNR of Pillow's,
tests/test_torch_codecs_host.py)."""
import numpy as np
import pytest
import torch

import chip_smoke as S
import rustcv_tpu.cv2 as R
import rustcv_tpu_torch.cv2 as P
from cv2_torch_parity import as_on_the_card, same

W, H, N = 160, 120, 4


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(float) - b.astype(float)) ** 2))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    frames = S.cv2_clip(W, H, N)
    tmp = tmp_path_factory.mktemp("slice")
    ref = S.cv2_write_read(R, frames, lambda a: a, str(tmp / "ref.avi"))
    ref["payloads"] = S.cv2_payloads(str(tmp / "ref.avi"))
    return frames, ref, tmp


def test_the_clip_is_written_and_read_back(clip, monkeypatch):
    frames, ref, tmp = clip
    with as_on_the_card(monkeypatch):
        port = S.cv2_write_read(P, frames, torch.from_numpy, str(tmp / "port.avi"))
    assert port["size"] == ref["size"] == (float(W), float(H))
    assert len(port["decoded"]) == len(ref["decoded"]) == N
    for f, p, r in zip(frames, port["decoded"], ref["decoded"]):
        assert p.shape == r.shape == f.shape and p.dtype == np.uint8
        assert _psnr(p, f) >= _psnr(r, f) - 0.5
    # each facade reads the other's file to the same frames
    for path in (tmp / "port.avi", tmp / "ref.avi"):
        caps = [cv.VideoCapture(str(path)) for cv in (R, P)]
        try:
            assert all(c.isOpened() for c in caps)
            for _ in range(N):
                (ok_r, fr), (ok_p, fp) = (c.read() for c in caps)
                assert ok_r and ok_p
                np.testing.assert_array_equal(fp, fr)
        finally:
            for c in caps:
                c.release()


@pytest.mark.parametrize("t", range(N))
def test_frame_calls(clip, t, monkeypatch):
    _frames, ref_clip, _tmp = clip
    frame, payload = ref_clip["decoded"][t], ref_clip["payloads"][t]
    ref = S.cv2_frame_calls(R, frame, payload, lambda a: a)
    with as_on_the_card(monkeypatch):
        port = S.cv2_frame_calls(P, frame, payload, torch.from_numpy)
    assert sorted(port) == sorted(ref)
    for name in ref:
        got = port[name].numpy() if isinstance(port[name], torch.Tensor) else port[name]
        if name.startswith("cornerHarris"):
            assert got.dtype == ref[name].dtype
            np.testing.assert_allclose(got, ref[name], **S.HARRIS_TOL)
        elif name.startswith("imencode"):
            a = R.imdecode(got, R.IMREAD_COLOR)
            b = R.imdecode(ref[name], R.IMREAD_COLOR)
            assert _psnr(a, frame) >= _psnr(b, frame) - 0.5
        else:
            same(ref[name], got, 0, name)


def test_clip_calls(clip, monkeypatch):
    _frames, ref_clip, _tmp = clip
    ref = S.cv2_clip_calls(R, ref_clip["decoded"], lambda a: a)
    with as_on_the_card(monkeypatch):
        port = S.cv2_clip_calls(P, ref_clip["decoded"], torch.from_numpy)
    assert sorted(port) == sorted(ref)
    for name in ref:
        if name.startswith("ORB"):
            np.testing.assert_array_equal(port[name][0], ref[name][0])
            d = np.abs((port[name][1] - ref[name][1] + 180) % 360 - 180)
            assert d.max(initial=0) <= np.degrees(1e-3)
            same(ref[name][2], port[name][2], 0, name)
        else:
            same(ref[name], port[name], 0, name)


def test_filestorage_of_the_corners(clip, tmp_path, monkeypatch):
    _frames, ref_clip, _tmp = clip
    g = R.cvtColor(ref_clip["decoded"][0], R.COLOR_BGR2GRAY)
    corners = R.goodFeaturesToTrack(g, 500, 0.01, 10)
    with as_on_the_card(monkeypatch):
        port_corners = P.goodFeaturesToTrack(torch.from_numpy(g), 500, 0.01, 10)
    same(corners, port_corners, 0)
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref = S.cv2_filestorage(R, corners, str(tmp_path / "r"))
    port = S.cv2_filestorage(P, port_corners, str(tmp_path / "p"))
    assert sorted(port) == sorted(ref) and {"json", "xml"} <= set(ref)
    for ext in ref:
        assert port[ext][1] == ref[ext][1], ext
        same(ref[ext][0], port[ext][0], 0, ext)
