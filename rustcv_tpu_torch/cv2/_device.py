"""Where a cv2 call runs, and the array conversions of the facade.

The rule, decided once here:

* a numpy image goes to the card: :func:`_m` uploads it into a Mat on the
  call's device, which is ``"cuda"`` unless a tensor argument names another,
  and raises where there is no card (``core.mat.torch_device``);
* a torch tensor stays on its device: the call's device is that of its
  first tensor argument (or of its first device Mat), so a CPU tensor runs
  the call on the CPU;
* results are numpy, as cv2's are (:func:`_o`);
* copied host code (the float64 geometry, the colour tables, the file
  formats) takes numpy arrays (:func:`_a` downloads a tensor) and runs on
  the host, as the reference's does.

A wrapper often turns its input into numpy before it makes a Mat (it pads,
flips channels, takes a plane). :func:`bind` wraps every public function
and method of a module so that the call's device is fixed when the call
enters the facade; a numpy array made inside the call goes to that device.
Nested calls keep the outer call's device.
"""

from __future__ import annotations

import contextvars
import functools
import inspect

import numpy as np
import torch

from ..core.mat import Mat, torch_device

_DEVICE = contextvars.ContextVar("rustcv_tpu_torch_cv2_device", default=None)


def _device_of(values):
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, Mat) and v.is_on_device:
            return v.device().device
        if isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, torch.Tensor):
                    return x.device
    return "cuda"


def current():
    """The device of the call in progress (the card outside any call)."""
    dev = _DEVICE.get()
    return "cuda" if dev is None else dev


def on_args(fn):
    """``fn`` run with the call's device taken from its arguments."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if _DEVICE.get() is not None:
            return fn(*args, **kwargs)
        token = _DEVICE.set(_device_of(list(args) + list(kwargs.values())))
        try:
            return fn(*args, **kwargs)
        finally:
            _DEVICE.reset(token)

    return call


def bind(namespace: dict) -> None:
    """Wrap the public functions that ``namespace``'s module defines, and the
    methods of its classes, with :func:`on_args`."""
    module = namespace["__name__"]
    for name, obj in list(namespace.items()):
        if getattr(obj, "__module__", None) != module:
            continue
        if inspect.isfunction(obj) and not name.startswith("_"):
            namespace[name] = on_args(obj)
        elif inspect.isclass(obj):
            for attr, member in list(vars(obj).items()):
                if attr.startswith("_") and attr not in ("__init__", "__call__"):
                    continue
                if isinstance(member, staticmethod):
                    setattr(obj, attr, staticmethod(on_args(member.__func__)))
                elif isinstance(member, classmethod):
                    setattr(obj, attr, classmethod(on_args(member.__func__)))
                elif inspect.isfunction(member):
                    setattr(obj, attr, on_args(member))


def _a(x, *args, **kwargs) -> np.ndarray:
    """``np.asarray`` that also takes a tensor (downloaded) or a Mat."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    elif isinstance(x, Mat):
        x = x.to_numpy()
    return np.asarray(x, *args, **kwargs)


def _t(x) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it is, an array goes to the
    call's device."""
    if isinstance(x, Mat):
        x = x.device() if x.is_on_device else x.to_numpy()
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(torch_device(current()))
    return x


def _m(a) -> Mat:
    """A Mat of ``a``: a Mat as it is, a tensor on its device, an array
    uploaded to the call's device. u8 only, as the reference's Mat."""
    if isinstance(a, Mat):
        return a
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.uint8:
            raise TypeError(f"Mat requires uint8, got {a.dtype}")
        return Mat.from_device((a[:, :, None] if a.ndim == 2 else a).contiguous())
    arr = np.ascontiguousarray(a)
    if arr.dtype != np.uint8:
        raise TypeError(f"Mat requires uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return Mat.from_device(torch.from_numpy(arr).to(torch_device(current())))


def _host_mat(a) -> Mat:
    """A host Mat over ``a``'s bytes (no copy for a contiguous u8 array):
    the in-place draws of a numpy image run there."""
    return Mat.from_array(np.ascontiguousarray(a), device="cpu")


def _hwc(a) -> np.ndarray:
    """A host (H, W, C) u8 array of an image, for host code (the reference's
    ``_m(a).to_numpy()``, without a trip to the card)."""
    x = _a(a)
    if x.dtype != np.uint8:
        raise TypeError(f"Mat requires uint8, got {x.dtype}")
    return np.ascontiguousarray(x[:, :, None] if x.ndim == 2 else x)


def _o(x) -> np.ndarray:
    """Mat, tensor or array → ndarray with cv2 shape conventions (gray is
    2-D)."""
    x = _a(x)
    if x.ndim == 3 and x.shape[2] == 1:
        x = x[:, :, 0]
    return x


def _copyto(dst, src) -> None:
    """``np.copyto`` into an array, or a copy into a tensor on its device
    (cv2's output arguments)."""
    if isinstance(dst, torch.Tensor):
        # numpy's broadcasting rule, and its ValueError where it fails
        src = np.broadcast_to(_a(src), tuple(dst.shape))
        dst.copy_(torch.tensor(src))
    else:
        np.copyto(dst, src)
