"""Time the host-staged path with each source cycling its own frames (the
simulation's form, bench.py's traffic: 8 separate cameras) beside the same
engine whose sources all cycle one shared frame list (one 4.1 MB frame read
8 times per tick, hot in the host's caches), on one CUDA card, in one
process.

    python -m rustcv_tpu_torch.probes.host_gather_ab [MODE ...]

Each MODE is a ``RUSTCV_DECODE`` mode (by default ``default``, ``pallas``
and ``pallas_tick``). The engine is bench.py's ``host_path_fps`` engine:
8 × 1920×1080 YUYV, ``n_unique_frames=8``, ``device_sim=False``,
``blur_sobel`` and the overlay. Forms run in turns
(shared, separate, separate, shared); each turn builds an engine, times 20
gathers alone (host clock, no upload), then a discarded warm run of 6 ticks
and 3 prefetching runs of 20. The last line is a JSON object of the
readings; it exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N, W, H, UNIQUE = 8, 1920, 1080, 8
RECT, COLOR = (100, 100, 400, 300), (0, 255, 0)
MODES = ("default", "pallas", "pallas_tick")
GATHERS, RUNS, TICKS = 20, 3, 20


def _engine(shared: bool):
    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.core import PixelFormat, SimpleConfig
    from rustcv_tpu_torch.runtime import MultiStreamEngine

    t0 = time.perf_counter()
    eng = MultiStreamEngine(
        SimulationDriver(device_count=N, paced=False, n_unique_frames=UNIQUE), N,
        SimpleConfig(width=W, height=H, fps=60, pixel_format=PixelFormat.YUYV),
        filter="blur_sobel", overlay=True, device_sim=False,
    )
    if shared:
        for src in eng.sources[1:]:
            src._cache = eng.sources[0]._cache
    return eng, time.perf_counter() - t0


def _turn(shared: bool, rects, colors) -> dict:
    import torch

    eng, setup_s = _engine(shared)
    eng.gather()
    t0 = time.perf_counter()
    for _ in range(GATHERS):
        eng.gather()
    gather_ms = (time.perf_counter() - t0) * 1e3 / GATHERS
    eng.run(6, warmup=0, measure_latency=False, rects=rects, rect_colors=colors)
    runs = [eng.run(TICKS, warmup=0, measure_latency=False, rects=rects, rect_colors=colors)
            for _ in range(RUNS)]
    torch.cuda.synchronize()
    eng.close()
    return {"setup_s": setup_s, "gather_alone_ms": gather_ms,
            "fps": [r.fps_total for r in runs], "host_gather_ms": [r.host_gather_ms for r in runs],
            "staging_waits": eng.staging_waits}


def main(argv=None) -> int:
    import numpy as np
    import torch

    args = list(sys.argv[1:] if argv is None else argv)
    if any(m not in MODES for m in args):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("host_gather_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rects = np.array([RECT] * N, np.int32)
    colors = np.array([COLOR] * N, np.uint8)
    result = {"card": smi}
    for mode in args or MODES:
        if mode == "default":
            os.environ.pop("RUSTCV_DECODE", None)
        else:
            os.environ["RUSTCV_DECODE"] = mode
        result[mode] = {"shared": [], "separate": []}
        for form in ("shared", "separate", "separate", "shared"):
            r = _turn(form == "shared", rects, colors)
            result[mode][form].append(r)
            print(f"{mode} {form}: set-up {r['setup_s']:.3f} s, gather alone "
                  f"{r['gather_alone_ms']:.4f} ms; runs "
                  f"{', '.join(f'{f:.2f}' for f in r['fps'])} frames/s, gather "
                  f"{', '.join(f'{g:.4f}' for g in r['host_gather_ms'])} ms; waits "
                  f"{r['staging_waits']}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
