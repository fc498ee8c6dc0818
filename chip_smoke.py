#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one card

The main path is the headline tick: 8 simulated streams of 1920×1080 YUYV
through ``MultiStreamEngine(device_sim=True, filter="blur_sobel",
overlay=True)``, in each of its three decode modes (default, and
``RUSTCV_DECODE=pallas`` / ``pallas_tick``). Phases:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions,
   and the build of the CUDA kernels from ``rustcv_tpu_torch/csrc``;
2. each kernel (K1 stencil, K4 decode+interleave, K5 fused tick) against
   its plain PyTorch version on the card, bit-exact, at 8×1920×1080 and at
   small ragged shapes, with rectangles across tiles and the frame edge;
3. the engine for 20 ticks in each decode mode, every output identical to
   a plain engine's (``stencil_impl="xla"``) on the card, the first and
   last ticks identical to the plain pipeline on the CPU fed by the host
   frame generator, and every kernel launched by that run;
4. ms/tick (CUDA events) and frames/s per mode, and each kernel's time
   beside its plain version's at 8×1920×1080.

It imports no jax and, of the JAX package, only what the port shares
(``rustcv_tpu.core``, through ``rustcv_tpu_torch.core``). Any mismatch or
error exits non-zero before the last line; the last line is the JSON
verdict, and the line before it the JSON list of kernels with their
launches, errors and times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N, W, H = 8, 1920, 1080
RECT, COLOR, THICKNESS = (100, 100, 400, 300), (0, 255, 0), 2  # bench.py's overlay
TICKS = 20
MODES = ("default", "pallas", "pallas_tick")

KERNELS = {  # name → (source, the Pallas kernel it replaces: file:line of pallas_call)
    "blur_sobel_mag": ("rustcv_tpu_torch/csrc/stencil.cu",
                       "rustcv_tpu/ops/pallas/stencil_v3.py:87"),
    "yuyv_decode_interleave": ("rustcv_tpu_torch/csrc/yuyv_tick.cu",
                               "rustcv_tpu/ops/pallas/decode_interleave.py:217"),
    "yuyv_tick_fused": ("rustcv_tpu_torch/csrc/yuyv_tick.cu",
                        "rustcv_tpu/ops/pallas/tick_fused.py:250"),
}


class SmokeFailure(Exception):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def set_mode(mode: str) -> None:
    if mode == "default":
        os.environ.pop("RUSTCV_DECODE", None)
    else:
        os.environ["RUSTCV_DECODE"] = mode


def max_abs_err(a, b) -> int:
    expect(a.shape == b.shape and a.dtype == b.dtype, f"shape/dtype {a.shape} {b.shape}")
    return int((a.int() - b.int()).abs().max().item())


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def overlay_args(w, h, n, dev, rng):
    """Per-stream rects: inside and across tiles, over the frame edges,
    thinner than the thickness; random colours."""
    import torch

    pool = [list(RECT), [-9, -5, w // 2 + 20, h // 3], [w - 50, h - 30, 200, 200],
            [w // 3, h // 3, 63, 33], [5, 5, 1, 1]]
    rects = torch.tensor([pool[i % len(pool)] for i in range(n)], dtype=torch.int32, device=dev)
    colors = torch.from_numpy(rng.integers(0, 256, (n, 3), np.uint8)).to(dev)
    return rects, colors


def check_kernels(dev) -> dict:
    """Phase 2: every kernel vs its plain version on the card."""
    import torch

    from rustcv_tpu_torch.ops.kernels import decode_interleave, stencil, tick_fused

    errs = {name: 0 for name in KERNELS}
    for (w, h, n) in ((W, H, N), (130, 50, 3), (64, 48, 2), (2, 1, 1)):
        rng = np.random.default_rng(w * 7919 + h)
        src = torch.from_numpy(rng.integers(0, 256, (n, h * w * 2), np.uint8)).to(dev)
        gray = torch.from_numpy(rng.integers(0, 256, (n, h, w), np.uint8)).to(dev)
        rects, colors = overlay_args(w, h, n, dev, rng)
        e = {"blur_sobel_mag": max_abs_err(stencil.blur_sobel_mag(gray),
                                           stencil.blur_sobel_mag_plain(gray))}
        for overlay in (True, False):
            args = (src, w, h, rects, colors, THICKNESS, overlay)
            got = decode_interleave.yuyv_decode_interleave(*args)
            want = decode_interleave.yuyv_decode_interleave_plain(*args)
            e["yuyv_decode_interleave"] = max(e.get("yuyv_decode_interleave", 0),
                                              *map(max_abs_err, got, want))
            got = tick_fused.yuyv_tick_fused(*args)
            want = tick_fused.yuyv_tick_fused_plain(*args)
            e["yuyv_tick_fused"] = max(e.get("yuyv_tick_fused", 0), *map(max_abs_err, got, want))
        torch.cuda.synchronize()
        print(f"kernels vs plain at N={n} {w}x{h}: max|diff| {e}", flush=True)
        for name, v in e.items():
            errs[name] = max(errs[name], v)
    expect(all(v == 0 for v in errs.values()), f"kernel disagrees with its plain version: {errs}")
    return errs


def make_engine(mode: str, stencil_impl=None):
    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.core import PixelFormat, SimpleConfig
    from rustcv_tpu_torch.runtime import MultiStreamEngine

    set_mode(mode)
    return MultiStreamEngine(
        SimulationDriver(device_count=N, paced=False), N,
        SimpleConfig(width=W, height=H, fps=60, pixel_format=PixelFormat.YUYV),
        filter="blur_sobel", overlay=True, device_sim=True, stencil_impl=stencil_impl,
    )


def bench_overlay():
    rects = np.tile(np.array([RECT], np.int32), (N, 1))
    colors = np.tile(np.array([COLOR], np.uint8), (N, 1))
    return rects, colors


def host_reference(seq: int):
    """The plain pipeline on the CPU, fed the host generator's frame."""
    import torch

    from rustcv_tpu_torch.capture.simulation import synth_raw
    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.runtime.pipeline import PipelineSpec, get_pipeline

    set_mode("default")
    fn = get_pipeline(PipelineSpec(PixelFormat.YUYV, W, H, filter="blur_sobel", overlay=True))
    raw = torch.from_numpy(synth_raw(W, H, PixelFormat.YUYV, seq))[None]
    rects, colors = bench_overlay()
    return fn(raw, torch.from_numpy(rects[:1]), torch.from_numpy(colors[:1]), THICKNESS)


def run_main_path() -> dict:
    """Phase 3: the engine in every decode mode vs the plain engine."""
    import torch

    from rustcv_tpu_torch.ops import kernels

    rects, colors = bench_overlay()
    plain = make_engine("default", stencil_impl="xla")
    kernels.reset_launch_counts()
    ref = [plain.tick(rects=rects, rect_colors=colors) for _ in range(TICKS)]
    torch.cuda.synchronize()
    expect(sum(kernels.launch_counts().values()) == 0, "the plain engine launched a kernel")
    plain.close()

    out0 = ref[0].outputs
    expect(tuple(out0["bgr"].shape) == (N, H, 3 * W) and out0["bgr"].dtype == torch.uint8,
           f"bgr {tuple(out0['bgr'].shape)} {out0['bgr'].dtype}")
    expect(tuple(out0["filtered"].shape) == (N, H, W), f"filtered {tuple(out0['filtered'].shape)}")
    expect(out0["bgr"][0, RECT[1], 3 * RECT[0]:3 * RECT[0] + 3].tolist() == list(COLOR),
           "the rectangle's corner does not carry its colour")
    expect(int(out0["filtered"].max()) > 0, "the filter output is all zero")
    for t, s in ((0, 0), (TICKS - 1, N - 1)):
        host = host_reference(int(ref[t].sequences[s]))
        for key in ("bgr", "filtered"):
            expect(torch.equal(ref[t].outputs[key][s:s + 1].cpu(), host[key]),
                   f"tick {t} stream {s} {key} differs from the host generator + CPU pipeline")
    print(f"plain engine on the card == host generator + CPU pipeline (ticks 0 and {TICKS - 1})",
          flush=True)

    kernels.reset_launch_counts()  # the main path's run starts here
    per_mode = {}
    for mode in MODES:
        before = kernels.launch_counts()
        eng = make_engine(mode)
        expect(eng.spec.stencil_impl == "pallas", f"default stencil on the card is {eng.spec.stencil_impl}")
        for t in range(TICKS):
            res = eng.tick(rects=rects, rect_colors=colors)
            for key in ("bgr", "filtered"):
                expect(torch.equal(res.outputs[key], ref[t].outputs[key]),
                       f"mode {mode} tick {t}: {key} differs from the plain engine")
        torch.cuda.synchronize()
        eng.close()
        after = kernels.launch_counts()
        per_mode[mode] = {k: after[k] - before[k] for k in after}
        print(f"engine mode {mode}: {TICKS} ticks identical to the plain engine; "
              f"launches {per_mode[mode]}", flush=True)
    totals = kernels.launch_counts()  # read just after the main path's run
    expect(per_mode["default"]["blur_sobel_mag"] > 0, "default mode never ran the stencil kernel")
    expect(per_mode["pallas"]["blur_sobel_mag"] > 0, "pallas mode never ran the stencil kernel")
    expect(per_mode["pallas"]["yuyv_decode_interleave"] > 0, "pallas mode never ran K4")
    expect(per_mode["pallas_tick"]["yuyv_tick_fused"] > 0, "pallas_tick mode never ran K5")
    expect(all(v > 0 for v in totals.values()), f"a kernel of the path never launched: {totals}")
    return totals


def time_engines() -> dict:
    """Phase 4a: ms/tick (CUDA events) and frames/s per mode, plain engine
    included, in two rounds of opposite order."""
    rects, colors = bench_overlay()
    order = [("plain", "default", "xla")] + [(m, m, None) for m in MODES]
    result = {name: [] for name, _, _ in order}
    for rnd in (order, order[::-1]):
        for name, mode, impl in rnd:
            eng = make_engine(mode, stencil_impl=impl)
            for _ in range(5):
                eng.tick(rects=rects, rect_colors=colors)
            ms = cuda_ms(lambda: eng.tick(rects=rects, rect_colors=colors), 50)
            stats = eng.run(50, warmup=2, measure_latency=False, rects=rects, rect_colors=colors)
            eng.close()
            result[name].append({"ms_per_tick": ms, "fps_events": N * 1e3 / ms,
                                 "fps_run": stats.fps_total})
    for name, runs in result.items():
        print(f"engine {name}: " + "; ".join(
            f"{r['ms_per_tick']:.4f} ms/tick, {r['fps_events']:.1f} frames/s (events), "
            f"{r['fps_run']:.1f} frames/s (run)" for r in runs), flush=True)
    return result


def time_kernels() -> dict:
    """Phase 4b: each kernel and its plain version at 8×1920×1080, in turns
    (plain, kernel, kernel, plain); returns name → (kernel ms, plain ms)."""
    import torch

    from rustcv_tpu_torch.ops.kernels import decode_interleave, stencil, tick_fused

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.integers(0, 256, (N, H * W * 2), np.uint8)).to(dev)
    gray = torch.from_numpy(rng.integers(0, 256, (N, H, W), np.uint8)).to(dev)
    rects = torch.tensor([RECT] * N, dtype=torch.int32, device=dev)
    colors = torch.tensor([COLOR] * N, dtype=torch.uint8, device=dev)
    args = (src, W, H, rects, colors, THICKNESS, True)
    pairs = {
        "blur_sobel_mag": (lambda: stencil.blur_sobel_mag(gray),
                           lambda: stencil.blur_sobel_mag_plain(gray)),
        "yuyv_decode_interleave": (lambda: decode_interleave.yuyv_decode_interleave(*args),
                                   lambda: decode_interleave.yuyv_decode_interleave_plain(*args)),
        "yuyv_tick_fused": (lambda: tick_fused.yuyv_tick_fused(*args),
                            lambda: tick_fused.yuyv_tick_fused_plain(*args)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        p1, k1, k2, p2 = (cuda_ms(plain, 10), cuda_ms(kern, 50), cuda_ms(kern, 50),
                          cuda_ms(plain, 10))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"{name} at N={N} {W}x{H}: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms", flush=True)
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from rustcv_tpu_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"kernels built in {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s): "
          f"{info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas: " + line.strip(), flush=True)

    dev = torch.device("cuda")
    try:
        errs = check_kernels(dev)
        launches = run_main_path()
        time_engines()
        times = time_kernels()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        os.environ.pop("RUSTCV_DECODE", None)

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
