"""Shape buckets: the resolutions a ``set_resolution`` hot swap is warmed
for (port of ``rustcv_tpu.runtime.buckets``).

The bucket set is the reference's own preset table (``bridge.m:236-241``,
``rustcv-backend-avf/src/stream.rs:281-289``). There is nothing to compile
in the port: warming a bucket builds its pipeline and runs it once, so the
first tick after a swap finds the pipeline and its tables (the resize
taps, the DCT basis) made, the kernels loaded and the caching allocator
sized.
"""

from __future__ import annotations

from typing import Iterable, Tuple

SHAPE_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (352, 288), (640, 480), (1280, 720), (1920, 1080), (3840, 2160),
)


def bucket_for(width: int, height: int) -> Tuple[int, int]:
    """Closest bucket by L1 distance (the preset-selection rule the AVF
    backend uses, stream.rs:272-307)."""
    return min(SHAPE_BUCKETS, key=lambda b: abs(b[0] - width) + abs(b[1] - height))


def _zero_input(spec, n_streams: int, device):
    """A batch of zero frames for ``spec``'s pipeline: raw bytes [N,
    raw_bytes], or for a hybrid MJPEG spec the dense 4:2:0 coefficient
    grids of whole 16×16 MCUs (Y, Cb, Cr; (N, bh, bw, 8, 8) int16) and two
    quant tables of ones."""
    import torch

    if not spec.mjpeg_hybrid:
        return torch.zeros((n_streams, spec.raw_bytes()), dtype=torch.uint8, device=device)
    mh, mw = -(-spec.height // 16), -(-spec.width // 16)
    grids = tuple(torch.zeros((n_streams, bh, bw, 8, 8), dtype=torch.int16, device=device)
                  for bh, bw in ((2 * mh, 2 * mw), (mh, mw), (mh, mw)))
    qts = tuple(torch.ones((8, 8), dtype=torch.int32, device=device) for _ in range(2))
    return grids + qts


def warm(specs: Iterable["object"], n_streams: int, device="cuda") -> int:
    """Build each spec's pipeline and run it once on zero frames on
    ``device``, synced; returns the number of specs warmed."""
    from .pipeline import get_pipeline, make_dummy_overlay

    count = 0
    for spec in specs:
        fn = get_pipeline(spec)
        fn(_zero_input(spec, n_streams, device), *make_dummy_overlay(n_streams, device))["_sync"].cpu()
        count += 1
    return count
