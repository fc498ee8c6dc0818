"""The port's cv2 namespace (``rustcv_tpu_torch.cv2``) against the
reference's (``rustcv_tpu.cv2``): every constant the reference defines is
in the port with an equal value and type; the port has no public name the
reference lacks; and each name the reference's later modules bring
(ROADMAP Queue 1 item 7b) raises ``not_ported`` in the port, from a frozen
list of the port's own that equals the reference's set."""
import types

import pytest

import rustcv_tpu.cv2 as R
import rustcv_tpu.cv2._constants as RC
import rustcv_tpu_torch.cv2 as P
import rustcv_tpu_torch.cv2._constants as PC
from cv2_torch_parity import later_names


def _constants(mod):
    return {n: v for n, v in vars(mod).items()
            if not n.startswith("_") and isinstance(v, (int, float, str))}


def test_every_reference_constant_is_in_the_port_with_its_value():
    ref = _constants(RC)
    assert len(ref) > 1800, len(ref)
    assert _constants(PC) == ref
    for name, value in ref.items():
        got = getattr(P, name)
        assert type(got) is type(value) and got == value, name


def test_the_port_has_no_public_name_the_reference_lacks():
    port = {n for n in dir(P) if not n.startswith("_")}
    ref = {n for n in dir(R) if not n.startswith("_")}
    assert port - ref == set()
    # the core's names are all there; what is missing is item 7b
    assert ref - port == later_names()


def test_the_frozen_item_7b_list_is_the_references():
    assert P._ITEM_7B == frozenset(later_names())
    assert len(P._ITEM_7B) == 300


@pytest.mark.parametrize("name", sorted(later_names()))
def test_an_item_7b_name_raises_not_ported(name):
    with pytest.raises(NotImplementedError, match=r"item 7\)"):
        getattr(P, name)
    with pytest.raises(NotImplementedError):
        hasattr(P, name)


def test_an_unknown_name_is_an_attribute_error():
    with pytest.raises(AttributeError):
        P.noSuchFunction  # noqa: B018
    assert not hasattr(P, "noSuchFunction")


def test_the_submodules_are_item_7b():
    subs = {n for n in dir(R) if not n.startswith("_")
            and isinstance(getattr(R, n), types.ModuleType)
            and getattr(R, n).__name__.startswith("rustcv_tpu.cv2.")}
    assert {"aruco", "detail", "dnn", "fisheye"} <= subs <= P._ITEM_7B
