"""Time this checkout's headline engine beside another checkout's, on one
CUDA card, in turns (other, this, this, other), each turn in a process of
its own.

    python -m rustcv_tpu_torch.probes.engine_ab OTHER_ROOT

OTHER_ROOT holds another version's ``rustcv_tpu_torch`` package, for
example the parent commit's (``git archive <commit> rustcv_tpu_torch |
tar -x -C OTHER_ROOT``). A turn builds that version's kernels, then times
the 8 × 1920×1080 headline tick (device-sim YUYV, ``blur_sobel``,
bench.py's overlay) in each decode mode and config 4's eager tick in the
default and ``pallas`` modes: CUDA events over 50 ticks after 5, the host's
issue included, as ``chip_smoke.py`` times them. Each turn prints one JSON
line (root → ms/tick per case); only a comparison within one call means
anything, since the host moves the eager ticks between calls.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

N, W, H = 8, 1920, 1080
RECT, COLOR = (100, 100, 400, 300), (0, 255, 0)
MODES = ("default", "pallas", "pallas_tick")
C4_MODES = ("default", "pallas")
TURN_TIMEOUT_S = 600


def _ms_per_tick(tick, reps: int = 50) -> float:
    import torch

    for _ in range(5):
        tick()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        tick()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _turn() -> dict:
    """Time the ``rustcv_tpu_torch`` first on ``sys.path``."""
    import numpy as np

    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.core import PixelFormat, SimpleConfig
    from rustcv_tpu_torch.models import get_model
    from rustcv_tpu_torch.runtime import MultiStreamEngine

    rects = np.tile(np.array([RECT], np.int32), (N, 1))
    colors = np.tile(np.array([COLOR], np.uint8), (N, 1))
    out = {}
    for mode in MODES + tuple(f"config4 {m}" for m in C4_MODES):
        decode = mode.split()[-1]
        if decode == "default":
            os.environ.pop("RUSTCV_DECODE", None)
        else:
            os.environ["RUSTCV_DECODE"] = decode
        if mode.startswith("config4"):
            eng = get_model("config4_harris_1080p").engine()
            out[mode] = _ms_per_tick(eng.tick)
        else:
            eng = MultiStreamEngine(
                SimulationDriver(device_count=N, paced=False), N,
                SimpleConfig(width=W, height=H, fps=60, pixel_format=PixelFormat.YUYV),
                filter="blur_sobel", overlay=True, device_sim=True)
            out[mode] = _ms_per_tick(lambda: eng.tick(rects=rects, rect_colors=colors))
        eng.close()
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--turn"]:
        sys.path.insert(0, os.getcwd())  # the turn's root, whose package it times
        print(json.dumps({"root": os.getcwd(), "ms_per_tick": _turn()}), flush=True)
        return 0
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("engine_ab: no CUDA device", file=sys.stderr)
        return 1
    this = Path(__file__).resolve().parents[2]
    other = Path(args[0]).resolve()
    for root in (other, this, this, other):
        # This file runs as a script in the root, which holds the package
        # it times (the other root may have no such probe).
        proc = subprocess.run([sys.executable, __file__, "--turn"], cwd=root,
                              capture_output=True, text=True, timeout=TURN_TIMEOUT_S)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
