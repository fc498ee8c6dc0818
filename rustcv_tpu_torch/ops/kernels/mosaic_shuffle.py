"""K7: the lane-shuffle cases of the Mosaic probe (``csrc/mosaic_shuffle.cu``).

Replaces the Pallas kernels of ``probe_mosaic_shuffle.py`` (the bodies of
its ``CASES``, run through ``pl.pallas_call`` at ``:166``): one small CUDA
kernel per case, a thread per output element. Each case's plain PyTorch
version below computes what the case's numpy ``ref`` computes, on the
case's fixed 2-D inputs (rows × lanes). The u32 words of
``sublane_bitcast`` travel as int32 with the same bits, and the u16
outputs are made through int16 (torch has few uint16 and uint32 ops).

    mosaic_shuffle("lane_roll", x)   # x int32 [8, 128] → int32 [8, 128]

The probe's entry point (:mod:`rustcv_tpu_torch.probes.mosaic_shuffle`)
runs every case on the card against its plain version and its ``ref``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from . import _build

launches = 0  # kernel launches since the last reset (see kernels.reset_launch_counts)

SLICE = (42, 170)  # unaligned_slice: x[:, 42:170]


def _u16(v: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65535] → uint16 (by way of int16's bits)."""
    return v.to(torch.int16).view(torch.uint16)


def _div3(x: torch.Tensor, width: int) -> torch.Tensor:
    """out[:, j] = x[:, j // 3] for j < width."""
    return x.index_select(1, torch.arange(width, device=x.device) // 3)


def _sublane_bitcast(x: torch.Tensor) -> torch.Tensor:
    """out[s, l] = byte s % 4 of word x[s // 4, l], little-endian."""
    rows, cols = x.shape
    return x.view(torch.uint8).reshape(rows, cols, 4).permute(0, 2, 1).reshape(4 * rows, cols)


def _select3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    lane = torch.arange(x.shape[1], device=x.device)
    return torch.where(lane % 3 == 0, x, y)


def _interleave3(w0, w1, w2) -> torch.Tensor:
    rows, cols = w0.shape
    return _u16(torch.stack([w0, w1, w2], dim=-1).reshape(rows, 3 * cols) & 0xFFFF)


def _u16_ops(x: torch.Tensor) -> torch.Tensor:
    w = x & 255
    return _u16(w | (w << 8))


class Case(NamedTuple):
    """One probe case: its input dtypes, its output (dtype, shape from the
    first input's shape) and its plain PyTorch version."""

    inputs: Tuple[torch.dtype, ...]
    out_dtype: torch.dtype
    out_shape: Callable[[int, int], Tuple[int, int]]
    plain: Callable[..., torch.Tensor]


I32, U8, U16 = torch.int32, torch.uint8, torch.uint16
# In the order of probe_mosaic_shuffle.CASES: the index is the case id of
# the CUDA launcher.
CASES: Dict[str, Case] = {
    "strided_load": Case((I32,), I32, lambda r, c: (r, (c + 1) // 2),
                         lambda x: x[:, ::2].contiguous()),
    "strided_store": Case((I32,), I32, lambda r, c: (r, 3 * c),
                          lambda x: (x[:, :, None] + torch.arange(3, dtype=I32, device=x.device)
                                     ).reshape(x.shape[0], -1)),
    "lane_gather": Case((I32,), I32, lambda r, c: (r, c), lambda x: _div3(x, x.shape[1])),
    "u8_select": Case((U8, U8), U8, lambda r, c: (r, c), _select3),
    "sublane_bitcast": Case((I32,), U8, lambda r, c: (4 * r, c), _sublane_bitcast),
    "lane_roll": Case((I32,), I32, lambda r, c: (r, c), lambda x: torch.roll(x, 1, dims=1)),
    "u8_astype": Case((I32,), U8, lambda r, c: (r, c), lambda x: (x & 255).to(U8)),
    "gather_128": Case((I32,), I32, lambda r, c: (r, c), lambda x: _div3(x, x.shape[1])),
    "unaligned_slice": Case((I32,), I32, lambda r, c: (r, SLICE[1] - SLICE[0]),
                            lambda x: x[:, SLICE[0]:SLICE[1]].contiguous()),
    "u16_astype": Case((I32,), U16, lambda r, c: (r, c), lambda x: _u16(x & 0xFFFF)),
    "repeat_lanes": Case((I32,), I32, lambda r, c: (r, 3 * c),
                         lambda x: _div3(x, 3 * x.shape[1])),
    "interleave3_vreg": Case((I32, I32, I32), U16, lambda r, c: (r, 3 * c), _interleave3),
    "u16_ops": Case((I32,), U16, lambda r, c: (r, c), _u16_ops),
}
CASE_IDS = {name: i for i, name in enumerate(CASES)}


def mosaic_shuffle_plain(name: str, *inputs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of case ``name``."""
    return CASES[name].plain(*inputs)


def mosaic_shuffle(name: str, *inputs: torch.Tensor) -> torch.Tensor:
    """Case ``name`` on its 2-D inputs (all of one shape and device).

    A CPU tensor takes the plain version; CUDA tensors launch the case's
    kernel on the current stream (no synchronisation)."""
    global launches
    if name not in CASES:
        raise ValueError(f"unknown case {name!r}; one of {list(CASES)}")
    case = CASES[name]
    if len(inputs) != len(case.inputs) or not all(isinstance(t, torch.Tensor) for t in inputs):
        raise ValueError(f"{name} takes {len(case.inputs)} tensor(s), got {len(inputs)}")
    rows, cols = inputs[0].shape if inputs[0].ndim == 2 else (0, 0)
    for i, (t, dtype) in enumerate(zip(inputs, case.inputs)):
        _build.expect(t, f"{name} input {i}", dtype, (rows, cols), inputs[0].device)
    if min(rows, cols) < 1 or (name == "unaligned_slice" and cols < SLICE[1]):
        raise ValueError(f"{name}: input shape {(rows, cols)} is too small")
    if inputs[0].device.type == "cpu":
        return case.plain(*inputs)
    out_rows, out_cols = case.out_shape(rows, cols)
    out = torch.empty((out_rows, out_cols), dtype=case.out_dtype, device=inputs[0].device)
    ptrs = [t.data_ptr() for t in inputs] + [None] * (3 - len(inputs))
    lib = _build.library()
    with torch.cuda.device(out.device):
        rc = lib.rcv_mosaic_shuffle(CASE_IDS[name], *ptrs, out.data_ptr(), cols, out_rows,
                                    out_cols, _build.stream_of(out))
    _build.check(rc, f"mosaic_shuffle {name}")
    launches += 1
    return out
