"""Mat — the stride-aware BGR image container (port of
``rustcv_tpu.core.mat``).

Reference parity:
- ``rustcv/src/core/mat.rs:6-52`` — rows/cols/channels + ``step`` (bytes per
  row, may exceed ``cols*channels`` for padded hardware layouts), ``row_bytes``,
  ``new/empty/is_empty``.
- ``rustcv-camera/src/mat.rs:20-129`` — ``ensure_size`` reallocates only when
  the dimensions actually change (zero allocation in steady-state read loops).

A Mat is **host-backed** (a NumPy ``uint8`` buffer of ``rows × step`` bytes,
the zero-copy interop surface) or **device-backed** (a packed (H, W, C) u8
``torch.Tensor``), or both. The two twins materialize lazily: ``device()``
uploads to the Mat's device (``"cuda"`` unless the caller names another),
``data``/``array`` download. Writing through ``data``/``array`` drops the
device twin; :meth:`set_device` drops the host twin. Asking for the card
where there is none raises: a Mat never stays on the CPU in its place.

Importing this module loads no torch; the device side imports it at first use.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _as_view3(buf: np.ndarray, rows: int, cols: int, channels: int, step: int) -> np.ndarray:
    """A (rows, cols, channels) u8 view into a (rows, step) stride-aware buffer."""
    return np.lib.stride_tricks.as_strided(
        buf, shape=(rows, cols, channels), strides=(step, channels, 1), writeable=True
    )


def torch_device(device):
    """``device`` as a ``torch.device``; raises where it names the card and
    torch has no CUDA device (no silent fallback to the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but torch.cuda.is_available() is False")
    return dev


def _shape_of(t):
    if t.ndim == 2:
        return t.shape[0], t.shape[1], 1
    rows, cols, ch = t.shape
    return rows, cols, ch


class Mat:
    """BGR (or generic n-channel) u8 image with explicit row stride.

    ``device`` is where :meth:`device` uploads the host bytes (default the
    card); a Mat made by :meth:`from_device` or :meth:`set_device` takes
    its tensor's device."""

    __slots__ = ("rows", "cols", "channels", "step", "_host", "_dev", "_target")

    def __init__(
        self,
        rows: int = 0,
        cols: int = 0,
        channels: int = 3,
        step: Optional[int] = None,
        device="cuda",
        _host: Optional[np.ndarray] = None,
        _dev=None,
    ):
        self.rows = rows
        self.cols = cols
        self.channels = channels
        self.step = step if step is not None else cols * channels
        if self.step < cols * channels:
            raise ValueError(f"step {self.step} < row_bytes {cols * channels}")
        self._host = _host
        self._dev = _dev
        self._target = device
        if rows > 0 and _host is None and _dev is None:
            self._host = np.zeros((rows, self.step), dtype=np.uint8)

    # ---- constructors -------------------------------------------------

    @classmethod
    def empty(cls) -> "Mat":
        """An empty Mat (reference: ``Mat::empty``)."""
        return cls(0, 0, 3, 0)

    @classmethod
    def new(cls, rows: int, cols: int, channels: int = 3, step: Optional[int] = None,
            device="cuda") -> "Mat":
        return cls(rows, cols, channels, step, device=device)

    @classmethod
    def zeros(cls, rows: int, cols: int, channels: int = 3) -> "Mat":
        return cls(rows, cols, channels)

    @classmethod
    def from_array(cls, arr: np.ndarray, device="cuda") -> "Mat":
        """Wrap an HWC (or HW) u8 NumPy array. Copies only if non-contiguous."""
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.dtype != np.uint8:
            raise TypeError(f"Mat requires uint8, got {arr.dtype}")
        arr = np.ascontiguousarray(arr)
        rows, cols, ch = arr.shape
        host = arr.reshape(rows, cols * ch)
        return cls(rows, cols, ch, cols * ch, device=device, _host=host)

    @classmethod
    def from_device(cls, dev_arr) -> "Mat":
        """Wrap a packed (H, W, C) (or (H, W)) u8 tensor without a copy."""
        rows, cols, ch = _shape_of(dev_arr)
        return cls(rows, cols, ch, cols * ch, device=dev_arr.device, _dev=dev_arr)

    # ---- basic queries (rustcv/src/core/mat.rs) -----------------------

    def is_empty(self) -> bool:
        return self.rows == 0 or self.cols == 0

    @property
    def row_bytes(self) -> int:
        """Meaningful bytes per row = cols*channels (reference ``row_bytes``)."""
        return self.cols * self.channels

    def total(self) -> int:
        return self.rows * self.cols

    @property
    def shape(self):
        return (self.rows, self.cols, self.channels)

    @property
    def target(self):
        """The device :meth:`device` uploads to."""
        return self._target

    # ---- host side -----------------------------------------------------

    def _materialize_host(self) -> np.ndarray:
        if self._host is None:
            host = np.zeros((self.rows, self.step), dtype=np.uint8)
            if self._dev is not None:
                packed = self._dev.cpu().numpy().reshape(self.rows, self.row_bytes)
                host[:, : self.row_bytes] = packed  # a copy: never aliases the tensor
            self._host = host
        return self._host

    @property
    def data(self) -> np.ndarray:
        """Raw stride-aware bytes, shape (rows, step). Mutating invalidates
        the device twin (call sites that mutate should use :meth:`array`)."""
        host = self._materialize_host()
        self._dev = None  # conservatively assume the caller mutates
        return host

    @property
    def array(self) -> np.ndarray:
        """Writable (rows, cols, channels) u8 view of the host pixels."""
        host = self._materialize_host()
        self._dev = None
        return _as_view3(host, self.rows, self.cols, self.channels, self.step)

    def to_numpy(self) -> np.ndarray:
        """Packed copy as (rows, cols, channels)."""
        if self._host is None and self._dev is not None:
            packed = self._dev.cpu().numpy().reshape(self.rows, self.cols, self.channels)
            return packed.copy() if self._dev.device.type == "cpu" else packed
        host = self._materialize_host()
        return _as_view3(host, self.rows, self.cols, self.channels, self.step).copy()

    # ---- device side ----------------------------------------------------

    @property
    def is_on_device(self) -> bool:
        return self._dev is not None

    def device(self):
        """The packed (H, W, C) u8 tensor; uploads the host bytes to the
        Mat's device if there is no device twin yet."""
        if self._dev is None:
            import torch

            dev = torch_device(self._target)
            packed = self.to_numpy() if self._host is not None else np.zeros(
                (self.rows, self.cols, self.channels), np.uint8
            )
            self._dev = torch.from_numpy(packed).to(dev)
        return self._dev

    def set_device(self, dev_arr) -> None:
        """Replace contents with a tensor (functional-update sink)."""
        rows, cols, ch = _shape_of(dev_arr)
        self.rows, self.cols, self.channels = rows, cols, ch
        self.step = cols * ch
        self._dev = dev_arr
        self._host = None
        self._target = dev_arr.device

    # ---- reuse semantics (rustcv-camera/src/mat.rs:65-74) --------------

    def ensure_size(self, rows: int, cols: int, channels: int = 3) -> None:
        """Reallocate only when dimensions change (steady-state zero-alloc)."""
        if (rows, cols, channels) == (self.rows, self.cols, self.channels) and (
            self._host is not None
        ):
            return
        self.rows, self.cols, self.channels = rows, cols, channels
        self.step = cols * channels
        self._host = np.zeros((rows, self.step), dtype=np.uint8)
        self._dev = None

    # ---- misc ----------------------------------------------------------

    def copy(self) -> "Mat":
        # Buffers go through the constructor: the bare Mat(rows, ...) form
        # would allocate and zero a full frame only to discard it. Tensors
        # are mutable, so the device twin is cloned too.
        return Mat(
            self.rows, self.cols, self.channels, self.step, device=self._target,
            _host=None if self._host is None else self._host.copy(),
            _dev=None if self._dev is None else self._dev.clone(),
        )

    def __repr__(self) -> str:
        loc = "device" if (self._dev is not None and self._host is None) else "host"
        return (
            f"Mat({self.rows}x{self.cols}x{self.channels}, step={self.step}, {loc})"
        )
