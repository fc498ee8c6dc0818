"""The rest of the port's cv2 facade (ROADMAP Queue 1 item 7b: ``_calib3d``,
``_algos``, ``_extras``, ``_misc3`` and the submodules ``aruco``, ``detail``,
``dnn``, ``fisheye``, ``utils``, ``samples``, ...) call for call against the
reference's (``rustcv_tpu.cv2``): one case per public callable of the later
modules and one per public callable of each submodule.

As ``tests/test_torch_cv2_calls.py`` does for the core: the same seeded
arguments (``cv2_callcov``'s synthesizer, 32×40 images) go to the reference
as numpy and to the port with their images as CPU tensors (the one rule:
:func:`port_args`), with ``np.asarray`` of a tensor refused as on the card;
the results and the arguments written in place are held equal, or within
the bar that :data:`BARS` states for the name. A reference call that raises
must raise the same exception class (by name) in the port. The metadata
functions and the multi-page and animated ones that decode each side's
own PNG or encode a GIF (other bytes: the port's writers) are held by
:data:`CHECKS` on what they decode to (item 8b).
"""
from __future__ import annotations

import types

import numpy as np
import pytest

import rustcv_tpu.cv2 as R
import rustcv_tpu_torch.cv2 as P
from cv2_torch_parity import (BARS, CHECKS, facade_get, later_callables,
                              later_names, later_plan, port_args, same)
from test_torch_cv2_calls import _release, _run, _run_port

NAMES = later_callables(R)
LATER = [n for n in NAMES if "." not in n]
FUNCTIONS = [n for n in NAMES if not isinstance(facade_get(R, n), type)]
CLASSES = [n for n in NAMES if isinstance(facade_get(R, n), type)]


def _features_check(ref, port, ra, pa):
    """ImageFeatures of ORB: index and size equal; keypoint positions and
    descriptors equal, angles within 1e-3 rad (the bar of ORB on a tensor
    against the reference's host path, tests/test_torch_cv2_classes.py)."""
    for r, p in zip(ref if isinstance(ref, list) else [ref], port if isinstance(port, list)
                    else [port]):
        assert (p.img_idx, p.img_size) == (r.img_idx, r.img_size)
        assert len(r.keypoints) > 0
        np.testing.assert_array_equal([k.pt for k in p.keypoints], [k.pt for k in r.keypoints])
        ang = np.array([k.angle for k in p.keypoints]) - np.array([k.angle for k in r.keypoints])
        assert np.abs((ang + 180) % 360 - 180).max() <= np.degrees(1e-3)
        same(r.descriptors, p.descriptors, 0)


CHECKS = dict(CHECKS, **{"detail.computeImageFeatures": _features_check,
                         "detail.computeImageFeatures2": _features_check})


def _plans(name, tmp_path):
    rf = facade_get(R, name)
    (tmp_path / "ref").mkdir(exist_ok=True)
    (tmp_path / "port").mkdir(exist_ok=True)
    ra, rk = later_plan(name, rf, tmp_path / "ref", R)
    pa, pk = port_args(rf, *later_plan(name, rf, tmp_path / "port", P))
    return ra, rk, pa, pk


@pytest.mark.parametrize("name", FUNCTIONS)
def test_call_matches_reference(name, tmp_path, monkeypatch):
    rf, pf = facade_get(R, name), facade_get(P, name)
    ra, rk, pa, pk = _plans(name, tmp_path)
    rout, rerr = _run(rf, ra, rk)
    pout, perr = _run_port(pf, pa, pk, monkeypatch)
    if rerr is not None:
        assert perr is not None, f"{name}: the reference raised {rerr!r}, the port returned"
        assert type(perr).__name__ == type(rerr).__name__, (name, rerr, perr)
        return
    if perr is not None:
        raise perr
    if name in CHECKS:
        CHECKS[name](rout, pout, ra, pa)
        return
    bar = BARS.get(name, (0, ""))[0]
    same(rout, pout, bar)
    for i, (r, p) in enumerate(zip(ra, pa)):
        if isinstance(r, np.ndarray):
            same(r, p, bar, f"argument {i} after the call")


@pytest.mark.parametrize("name", CLASSES)
def test_class_constructs_as_reference(name, tmp_path, monkeypatch):
    rc, pc = facade_get(R, name), facade_get(P, name)
    ra, rk, pa, pk = _plans(name, tmp_path)
    robj, rerr = _run(rc, ra, rk)
    pobj, perr = _run_port(pc, pa, pk, monkeypatch)
    try:
        if rerr is not None:
            assert perr is not None and type(perr).__name__ == type(rerr).__name__, (rerr, perr)
            assert "rustcv_tpu_torch" in str(perr) or "rustcv_tpu" not in str(rerr), perr
            return
        if perr is not None:
            raise perr
        assert type(pobj).__name__ == type(robj).__name__
        assert sorted(n for n in dir(pc) if not n.startswith("_")) == \
            sorted(n for n in dir(rc) if not n.startswith("_"))
    finally:
        for o in (robj, pobj):
            if o is not None:
                _release(o)


def test_the_sweep_covers_item_7b():
    """Every 7b callable and every submodule callable is a case, the port
    has each of them, and the port's own list (which the card tests sweep)
    is the reference's."""
    assert len(LATER) == 282 and len(NAMES) > 380, (len(LATER), len(NAMES))
    assert set(LATER) == {n for n in later_names()
                          if callable(getattr(R, n)) and not isinstance(getattr(R, n),
                                                                         types.ModuleType)}
    for n in NAMES:
        assert callable(facade_get(P, n)), n
    assert later_callables(P) == NAMES
