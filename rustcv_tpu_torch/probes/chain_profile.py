"""Count how often ``torch.profiler`` loses kernel records of a chained
tick's CUDA-graph replay, on one CUDA card.

    python -m rustcv_tpu_torch.probes.chain_profile [REPS]

For BASELINE config 1 (default mode) and config 4 (default and
``pallas``), as ``chip_smoke.py`` chains them (32 ticks per graph, the
bench overlay), it counts what the kernel wrappers launch in one eager
tick, captures the chain, and profiles REPS replays (40 by default), each
from the same clock. Every replay makes the same kernels, so a replay
whose device records number fewer than the most seen lost some; for each
such replay it prints the records seen, our kernels' counts against 32 ×
the eager tick's, the replay's probe against the first replay's, and
where our first kernel lies. The last line is a JSON object of the
readings; it exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHAIN = 32
CASES = (("config1_convert_overlay", "default"), ("config4_harris_1080p", "default"),
         ("config4_harris_1080p", "pallas"))
RECT, COLOR, THICKNESS = (100, 100, 400, 300), (0, 255, 0), 2
# the device kernels' names, as the profiler lists them (both Harris forms
# run harris_kernel)
KERNEL_NAMES = {"blur_sobel_mag": "blur_sobel_kernel",
                "yuyv_decode_interleave": "decode_interleave_kernel",
                "yuyv_tick_fused": "tick_fused_kernel", "harris_response": "harris_kernel"}


def _profile(fn):
    """(all device records, start µs of each, in order, by label) of one
    synced call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    ours = {}
    for e in kern:
        for label, name in KERNEL_NAMES.items():
            if name in e.name:
                ours.setdefault(label, []).append(e.time_range.start - kern[0].time_range.start)
    return len(kern), ours


def _case(name: str, mode: str, reps: int) -> dict:
    import numpy as np
    import torch

    from rustcv_tpu_torch.models import get_model
    from rustcv_tpu_torch.ops import kernels

    if mode == "default":
        os.environ.pop("RUSTCV_DECODE", None)
    else:
        os.environ["RUSTCV_DECODE"] = mode
    eng = get_model(name).engine()
    rects, colors = np.array([RECT], np.int32), np.array([COLOR], np.uint8)
    before = kernels.launch_counts()
    eng.tick(rects=rects, rect_colors=colors, thickness=THICKNESS, block=True)
    tick = {}
    for kname, n in kernels.launch_counts().items():
        if n > before[kname]:
            label = "harris_response" if kname.startswith("harris_response") else kname
            tick[label] = tick.get(label, 0) + n - before[kname]
    want = {label: CHAIN * n for label, n in tick.items()}
    ch = eng._chain(CHAIN)
    ch.rects.copy_(torch.from_numpy(rects))
    ch.colors.copy_(torch.from_numpy(colors))
    reads, probes = [], []
    for _ in range(reps):
        ch.seqs.zero_()
        reads.append(_profile(ch.dispatch))
        probes.append(int(ch.sync.item()))
    eng.close()
    most = max(n for n, _ in reads)
    short = []
    for rep, (n, ours) in enumerate(reads):
        counts = {label: len(t) for label, t in ours.items()}
        if n < most or counts != want:
            first = min((t[0] for t in ours.values()), default=None)
            short.append({"rep": rep, "records": n, "ours": counts, "probe_same": probes[rep] == probes[0],
                          "first_ours_us": first})
    return {"want": want, "records": most, "reps": reps, "short": short,
            "probes_same": all(p == probes[0] for p in probes)}


def main(argv=None) -> int:
    import torch

    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) > 1 or (args and not (args[0].isdigit() and int(args[0]) > 0)):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chain_profile: no CUDA device", file=sys.stderr)
        return 1
    reps = int(args[0]) if args else 40
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    result = {"card": smi, "chain": CHAIN}
    for name, mode in CASES:
        r = _case(name, mode, reps)
        result[f"{name} {mode}"] = r
        for s in r["short"]:
            print(f"{name} {mode} replay {s['rep']}: {s['records']} device records of {r['records']}; "
                  f"ours {s['ours']} of {r['want']}; probe as the first replay's {s['probe_same']}; "
                  f"our first kernel {s['first_ours_us']} us after the first record", flush=True)
        print(f"{name} {mode}: {len(r['short'])} of {reps} replays short; every probe the same "
              f"{r['probes_same']}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
