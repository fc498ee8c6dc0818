"""Time this checkout's kernels (K1 blur + Sobel, K4 decode + interleave,
K5 fused tick, K6 Harris response in both forms) beside another
checkout's, on one CUDA card, in one process.

    python -m rustcv_tpu_torch.probes.kernel_ab OTHER_ROOT

OTHER_ROOT holds another version's ``rustcv_tpu_torch`` package, for
example the parent commit's: ``git archive <commit> rustcv_tpu_torch |
tar -x -C OTHER_ROOT``. Each version's kernel library is built from its own
``csrc`` (nvcc, sm_90a) and its ptxas lines are printed. At the main path's
shapes (K1 at 8 × 1920×1080 and config 6's 8 × 640×480; K5 at 8 ×
1920×1080 with bench.py's overlay) both versions' outputs are held against
the plain PyTorch version (bit-exact), then timed with CUDA events in turns
(other, this, this, other), queued behind a spin kernel so that the host's
issue does not pace them: warm, and with the input cold in L2 (rotating
over copies that together exceed it). The last line is a JSON object of
the times; it exits non-zero on a mismatch or without a card.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

N, W, H = 8, 1920, 1080
VGA = (640, 480)
RECT, COLOR, THICKNESS = (100, 100, 400, 300), (0, 255, 0), 2
COLD_BYTES = 64e6  # > the 50 MB L2
REPS = 50


def _load_build(root: Path, name: str):
    path = root / "rustcv_tpu_torch" / "ops" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _events_ms(fn, inputs, reps: int) -> float:
    """Mean device ms per call of ``fn(x)``, x rotating over ``inputs``.
    The calls queue behind a spin kernel longer than their issue takes, so
    the events time the device alone, not the host's pace."""
    import time

    import torch

    fn(inputs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(inputs[(i + 1) % len(inputs)])
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(issue_s * 2 * 2e9) + 100_000)  # cycles, at up to 2 GHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(inputs[(i + 1) % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _check(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"kernel launch failed with CUDA error {rc}")


def _cold(t) -> list:
    k = max(2, -(-int(COLD_BYTES) // t.numel()))
    return [t] + [t.clone() for _ in range(k - 1)]


def main(argv=None) -> int:
    import torch

    from rustcv_tpu_torch.ops.kernels import _build, decode_interleave, harris, stencil, tick_fused

    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    other_build = _load_build(Path(args[0]).resolve(), "kernel_ab_other_build")
    libs = {}
    for label, mod in (("other", other_build), ("this", _build)):
        libs[label] = mod.library()
        print(f"{label}: built in {mod.build_info['seconds']:.2f} s: {mod.build_info['path']}",
              flush=True)
        for line in mod.build_info["log"].splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  {label} ptxas: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(4)
    gray = torch.from_numpy(rng.integers(0, 256, (N, H, W), np.uint8)).to(dev)
    vga = gray[:, :VGA[1], :VGA[0]].contiguous()
    src = torch.from_numpy(rng.integers(0, 256, (N, H * W * 2), np.uint8)).to(dev)
    rects = torch.tensor([RECT] * N, dtype=torch.int32, device=dev)
    colors = torch.tensor([COLOR] * N, dtype=torch.uint8, device=dev)

    def k1(lib):
        def run(g, out=None):
            n, h, w = g.shape
            out = torch.empty_like(g) if out is None else out
            _check(lib.rcv_blur_sobel_mag(g.data_ptr(), out.data_ptr(), n, h, w, stream))
            return out
        return run

    def k5(lib):
        bgr = torch.empty((N, H, 3 * W), dtype=torch.uint8, device=dev)
        filt = torch.empty((N, H, W), dtype=torch.uint8, device=dev)

        def run(s):
            _check(lib.rcv_yuyv_tick_fused(s.data_ptr(), rects.data_ptr(), colors.data_ptr(),
                                           THICKNESS, 1, bgr.data_ptr(), filt.data_ptr(), N, H,
                                           W, stream))
            return bgr, filt
        return run

    def k4(lib):
        bgr = torch.empty((N, H, 3 * W), dtype=torch.uint8, device=dev)
        g = torch.empty((N, H, W), dtype=torch.uint8, device=dev)

        def run(s):
            _check(lib.rcv_yuyv_decode_interleave(s.data_ptr(), rects.data_ptr(),
                                                  colors.data_ptr(), THICKNESS, 1, bgr.data_ptr(),
                                                  g.data_ptr(), N, H, W, stream))
            return bgr, g
        return run

    def k6(form, dtype):
        def make(lib):
            def run(g):
                n, h, w = g.shape
                out = torch.empty(g.shape, dtype=dtype, device=dev)
                if form == "i32":
                    _check(lib.rcv_harris_response_i32(g.data_ptr(), out.data_ptr(), n, h, w, 41,
                                                       stream))
                else:
                    _check(lib.rcv_harris_response_f32(g.data_ptr(), out.data_ptr(), n, h, w,
                                                       ctypes.c_float(0.04), stream))
                return out
            return run
        return make

    one = gray[:1].contiguous()
    cases = [
        ("K1 blur_sobel_mag N=8 1920x1080", k1, gray, lambda x: (stencil.blur_sobel_mag_plain(x),)),
        ("K1 blur_sobel_mag N=8 640x480", k1, vga, lambda x: (stencil.blur_sobel_mag_plain(x),)),
        ("K4 yuyv_decode_interleave N=8 1920x1080", k4, src,
         lambda x: decode_interleave.yuyv_decode_interleave_plain(x, W, H, rects, colors, THICKNESS,
                                                                  True)),
        ("K5 yuyv_tick_fused N=8 1920x1080", k5, src,
         lambda x: tick_fused.yuyv_tick_fused_plain(x, W, H, rects, colors, THICKNESS, True)),
        ("K6 harris_response_i32 N=1 1920x1080", k6("i32", torch.int32), one,
         lambda x: (harris.harris_response_i32_plain(x, 41),)),
        ("K6 harris_response_i32 N=8 1920x1080", k6("i32", torch.int32), gray,
         lambda x: (harris.harris_response_i32_plain(x, 41),)),
        ("K6 harris_response_f32 N=8 1920x1080", k6("f32", torch.float32), gray,
         lambda x: (harris.harris_response_plain(x, 0.04),)),
    ]
    result = {"card": smi}
    ok = True
    for label, make, x, plain in cases:
        want = plain(x)
        runs = {v: make(libs[v]) for v in libs}
        for v, fn in runs.items():
            got = fn(x)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ok &= same
            print(f"{label}: {v} {'equals' if same else 'DIFFERS FROM'} the plain version",
                  flush=True)
        cold = _cold(x)
        warm = [x]
        t = {v: {"warm_ms": [], "cold_ms": []} for v in runs}
        for v in ("other", "this", "this", "other"):
            t[v]["warm_ms"].append(_events_ms(runs[v], warm, REPS))
        for v in ("other", "this", "this", "other"):
            t[v]["cold_ms"].append(_events_ms(runs[v], cold, REPS))
        del cold
        torch.cuda.empty_cache()
        result[label] = t
        print(f"{label}: " + "; ".join(
            f"{v} warm {' / '.join(f'{m:.4f}' for m in t[v]['warm_ms'])} ms, cold "
            f"{' / '.join(f'{m:.4f}' for m in t[v]['cold_ms'])} ms" for v in t), flush=True)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
