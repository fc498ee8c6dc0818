"""The Mosaic lane-shuffle probe on the card: the counterpart of
``probe_mosaic_shuffle.py``, whose Pallas kernels are K7.

    python -m rustcv_tpu_torch.probes.mosaic_shuffle [name ...]

For each case (all of them, in the JAX script's order, by default) it makes
the case's inputs with numpy, runs the case's CUDA kernel
(:mod:`rustcv_tpu_torch.ops.kernels.mosaic_shuffle`) and its plain PyTorch
version on the same CUDA tensors, and holds both against the case's numpy
``ref`` (a copy of the JAX script's). It prints one line per case in the
JAX script's format, ``CASE_RESULT '<name>' exact`` or ``... MISMATCH``,
and exits non-zero if a case mismatched or no CUDA device is present. The
cases run in one process: the JAX script's process per case guarded
against Mosaic's aborts, which CUDA does not have.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np


def _arange(n: int, cols: int, dtype=np.int32, scale: int = 1, offset: int = 0) -> np.ndarray:
    return (np.arange(n * cols, dtype=dtype) * scale + offset).reshape(n, cols)


def _strided_store_ref(x):
    ref = np.zeros((8, 384), np.int32)
    ref[:, ::3], ref[:, 1::3], ref[:, 2::3] = x, x + 1, x + 2
    return ref


def _sublane_bitcast_ref(x):
    xv = x.view(np.uint32)
    ref = np.zeros((32, 128), np.uint8)
    for s in range(32):
        ref[s] = (xv[s // 4] >> (8 * (s % 4))).astype(np.uint8)
    return ref


def _interleave3_ref(*ws):
    ref = np.zeros((8, 384), np.uint16)
    for s in range(3):
        ref[:, s::3] = (ws[s] & 0xFFFF).astype(np.uint16)
    return ref


def _u16_ops_ref(x):
    v = (x & 255).astype(np.uint16)
    return v | (v << 8)


class Probe(NamedTuple):
    """A case's inputs (numpy, as the JAX script builds them) and its
    numpy ``ref`` of them."""

    inputs: Callable[[], Tuple[np.ndarray, ...]]
    ref: Callable[..., np.ndarray]


# The JAX script's CASES, in its order. sublane_bitcast's u32 words are
# passed as int32 with the same bits.
PROBES: Dict[str, Probe] = {
    "strided_load": Probe(lambda: (_arange(8, 256),), lambda x: x[:, ::2]),
    "strided_store": Probe(lambda: (_arange(8, 128),), _strided_store_ref),
    "lane_gather": Probe(lambda: (_arange(8, 384),), lambda x: x[:, np.arange(384) // 3]),
    "u8_select": Probe(
        lambda: (np.full((8, 384), 7, np.uint8), np.full((8, 384), 9, np.uint8)),
        lambda x, y: np.broadcast_to(
            np.where((np.arange(384) % 3 == 0)[None, :], 7, 9).astype(np.uint8), (8, 384))),
    "sublane_bitcast": Probe(lambda: (_arange(8, 128, np.uint32).view(np.int32),),
                             _sublane_bitcast_ref),
    "lane_roll": Probe(lambda: (_arange(8, 128),), lambda x: np.roll(x, 1, axis=1)),
    "u8_astype": Probe(lambda: (_arange(8, 384),), lambda x: (x & 255).astype(np.uint8)),
    "gather_128": Probe(lambda: (_arange(8, 128),), lambda x: x[:, np.arange(128) // 3]),
    "unaligned_slice": Probe(lambda: (_arange(8, 256),), lambda x: x[:, 42:170]),
    "u16_astype": Probe(lambda: (_arange(8, 384, scale=257),),
                        lambda x: (x & 0xFFFF).astype(np.uint16)),
    "repeat_lanes": Probe(lambda: (_arange(8, 128),), lambda x: np.repeat(x, 3, axis=1)),
    "interleave3_vreg": Probe(
        lambda: tuple(_arange(8, 128, offset=10000 * s) for s in range(3)), _interleave3_ref),
    "u16_ops": Probe(lambda: (_arange(8, 384),), _u16_ops_ref),
}


def run_case(name: str, device) -> dict:
    """Case ``name`` on ``device``: the kernel's output (the plain version
    on a CPU device), the plain version's and the ``ref``, as numpy."""
    import torch

    from rustcv_tpu_torch.ops.kernels import mosaic_shuffle as k7

    inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in PROBES[name].inputs()]
    got = k7.mosaic_shuffle(name, *inputs)
    want = k7.mosaic_shuffle_plain(name, *inputs)
    return {"kernel": got.cpu().numpy(), "plain": want.cpu().numpy(),
            "ref": np.asarray(PROBES[name].ref(*(t.cpu().numpy() for t in inputs)))}


def exact(result: dict) -> bool:
    """Kernel, plain version and ``ref`` equal in shape, dtype and value."""
    ref = result["ref"]
    return all(a.shape == ref.shape and a.dtype == ref.dtype and np.array_equal(a, ref)
               for a in (result["kernel"], result["plain"]))


def main(argv=None) -> int:
    import torch

    names = list(sys.argv[1:] if argv is None else argv) or list(PROBES)
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        print(f"unknown case(s) {unknown}; one of {list(PROBES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("the probe runs on a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    ok = True
    for name in names:
        result = run_case(name, torch.device("cuda"))
        ok &= exact(result)
        print("CASE_RESULT", repr(name), "exact" if exact(result) else "MISMATCH", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
