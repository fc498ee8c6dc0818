"""The port's cv2 namespace (``rustcv_tpu_torch.cv2``) against the
reference's (``rustcv_tpu.cv2``): every constant the reference defines is
in the port with an equal value and type; the two have the same public
names; and each name the reference's later modules bring (ROADMAP Queue 1
item 7b, once a frozen list of names that raised ``not_ported``) resolves
in the port to the reference's kind of object, a callable with the
reference's parameter names. Of those, the six that the reference runs
with Pillow for multi-page and animated files raise ``not_ported`` (items
8b and 8c) when called; the two metadata ones (item 8a) answer as the
reference answers."""
import importlib
import inspect
import types

import numpy as np
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
    # and the reference has none the port lacks: item 7b is ported
    assert ref - port == set()


def test_the_frozen_item_7b_list_is_the_references():
    """The frozen list and the module ``__getattr__`` that raised from it
    are gone; the 300 names the reference's later modules bring are the
    port's own attributes."""
    assert not hasattr(P, "_ITEM_7B") and "__getattr__" not in vars(P)
    later = later_names()
    assert len(later) == 300
    assert later <= set(vars(P))


def _kind(v):
    if isinstance(v, types.ModuleType):
        return "module"
    if isinstance(v, type):
        return "class"
    return "function" if callable(v) else type(v).__name__


def _params(f):
    return list(inspect.signature(f).parameters)


def _buf(head):
    return np.frombuffer(head + bytes(24), np.uint8)


def _outcome(fn, args, kwargs):
    """A call's answer in comparable form (an Animation as its fields), or
    the name of what it raised."""
    try:
        out = fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__
    if isinstance(out, tuple) and len(out) == 2 and hasattr(out[1], "durations"):
        out = (out[0], out[1].frames, out[1].durations, out[1].loop_count)
    return [np.asarray(x).tolist() if isinstance(x, np.ndarray) else x for x in
            (out if isinstance(out, tuple) else (out,))]


def _png_with_text():
    import io

    from PIL import Image, PngImagePlugin

    info, buf = PngImagePlugin.PngInfo(), io.BytesIO()
    info.add_text("Title", "x")
    Image.fromarray(np.arange(48, dtype=np.uint8).reshape(4, 4, 3)).save(buf, "PNG", pnginfo=info)
    return np.frombuffer(buf.getvalue(), np.uint8)


METADATA_CALLS = {
    "imdecodeWithMetadata": (_png_with_text(),),
    "imencodeWithMetadata": (".bmp", np.arange(48, dtype=np.uint8).reshape(4, 4, 3)),
}
PILLOW_BOUND = {
    "imencodemulti": ((".tiff", []), {}), "imdecodemulti": ((_buf(b"II*\x00"),), {}),
    "imreadanimation": ((__file__,), {}), "imwriteanimation": (("a.gif", None), {}),
    "imdecodeanimation": ((_buf(b"GIF89a"),), {}),
    "imencodeanimation": ((".gif", None), {}),
}


@pytest.mark.parametrize("name", sorted(later_names()))
def test_an_item_7b_name_raises_not_ported(name, tmp_path):
    """Item 7b's names no longer raise ``not_ported`` on access: each
    resolves to the reference's kind (module, class, function or
    constant), a constant to its value, a callable with the reference's
    parameter names (a class: its constructor's and the same public
    members). The six functions the reference runs with Pillow for
    multi-page and animated files (item 8b) and the two metadata ones
    answer as the reference's when called."""
    ref, port = getattr(R, name), getattr(P, name)
    assert _kind(port) == _kind(ref), (name, _kind(port), _kind(ref))
    if isinstance(ref, types.ModuleType):
        assert port.__name__ == ref.__name__.replace("rustcv_tpu.", "rustcv_tpu_torch.", 1)
    elif isinstance(ref, type):
        assert _params(port) == _params(ref)
        assert sorted(n for n in dir(port) if not n.startswith("_")) == \
            sorted(n for n in dir(ref) if not n.startswith("_"))
    elif callable(ref):
        assert _params(port) == _params(ref)
    else:
        assert type(port) is type(ref) and port == ref
    if name in PILLOW_BOUND:
        args, kwargs = PILLOW_BOUND[name]
        if name == "imreadanimation":
            path = tmp_path / "a.gif"
            path.write_bytes(b"GIF89a" + bytes(20))
            args = (str(path),)
        assert _outcome(port, args, kwargs) == _outcome(ref, args, kwargs)
    if name in METADATA_CALLS:
        args = METADATA_CALLS[name]
        got, want = port(*args), ref(*args)
        assert [np.asarray(x).tolist() if isinstance(x, np.ndarray) else x for x in got] == \
            [np.asarray(x).tolist() if isinstance(x, np.ndarray) else x for x in want]


def test_an_unknown_name_is_an_attribute_error():
    with pytest.raises(AttributeError):
        P.noSuchFunction  # noqa: B018
    assert not hasattr(P, "noSuchFunction")


def test_the_submodules_are_item_7b():
    """The reference's submodules (item 7b) are the port's: each module of
    ``rustcv_tpu.cv2`` has its ``rustcv_tpu_torch.cv2`` counterpart, the
    same object under both of the port's spellings (``cv2.aruco`` and
    ``cv2.aruco_*``'s module)."""
    subs = {n for n in dir(R) if not n.startswith("_")
            and isinstance(getattr(R, n), types.ModuleType)
            and getattr(R, n).__name__.startswith("rustcv_tpu.cv2.")}
    assert {"aruco", "detail", "dnn", "fisheye"} <= subs <= later_names()
    for n in subs:
        assert getattr(P, n).__name__ == f"rustcv_tpu_torch.cv2.{n}"
        assert getattr(P, n) is importlib.import_module(f"rustcv_tpu_torch.cv2.{n}")
