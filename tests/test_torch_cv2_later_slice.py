"""Phase 3u's cv2 user's script (``chip_smoke.cv2l_call``: the rest of the
cv2 facade, ROADMAP Queue 1 item 7b) at 160×120 × 4 frames, its host
copies on a 320×180 resize and its ArUco page at 320×180: the reference's
facade on numpy against the port's on CPU tensors, refusing implicit numpy
conversions as tensors on the card do. Each job also runs through the
smoke's own bars (``chip_smoke.cv2l_check``).

Bars: equal, but for Farnebäck (the flow bar of tests/test_torch_flow.py:
99 % of |Δ| under 1e-3 px, all under 0.05), sparse LK (status equal,
points within 1e-3 px) and the quality of ``goodFeaturesToTrackWithQuality``
(the reference's Harris bar, HARRIS_TOL), where the port runs the device
twin on the CPU and the reference its host oracle."""
import numpy as np
import pytest
import torch

import chip_smoke as S
import rustcv_tpu.cv2 as R
import rustcv_tpu_torch.cv2 as P
from cv2_torch_parity import as_on_the_card, same

W, H, N = 160, 120, 4


@pytest.fixture(autouse=True)
def small_sizes(monkeypatch):
    monkeypatch.setattr(S, "CV2L_SMALL", (320, 180))
    monkeypatch.setattr(S, "CV2L_MARKERS", (320, 180, 48))
    monkeypatch.setattr(S, "CV2L_DETAIL", (200, 120))


@pytest.fixture(scope="module")
def frames():
    return S.cv2_clip(W, H, N)


def _plain(x):
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    return x.numpy() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("job", S.cv2l_jobs(N))
def test_job_matches_reference(job, frames, monkeypatch):
    ref = S.cv2l_call(R, job, frames, lambda a: a)
    with as_on_the_card(monkeypatch):
        port = S.cv2l_call(P, job, frames, torch.from_numpy)
    port = {k: _plain(v) for k, v in port.items()}
    assert sorted(port) == sorted(ref)
    for name in ref:
        S.cv2l_check(name, port[name], _plain(ref[name]))
        if name.split()[0] not in ("FarnebackOpticalFlow.calc", "SparsePyrLKOpticalFlow.calc",
                                   "goodFeaturesToTrackWithQuality"):
            same(_plain(ref[name]), port[name], 0, name)


def test_the_truths(frames):
    """What has a truth finds it at this size too: the QR text, the four
    markers, the calibration's K."""
    out = {}
    for job in ("qr", "aruco", "calibration"):
        out.update(S.cv2l_call(P, job, frames, torch.from_numpy))
    assert out["QRCodeEncoder.encode + QRCodeDetector.detectAndDecode"][0] == S.CV2L_QR
    assert sorted(out["aruco.ArucoDetector.detectMarkers"][1].ravel().tolist()) == \
        sorted(S.CV2L_MARKER_IDS)
    K = out["calibrateCameraExtended"][1]
    assert np.abs(K[:2, :3] - S.CV2L_CALIB_K[:2, :3]).max() < 0.01 * S.CV2L_CALIB_K[0, 0]
