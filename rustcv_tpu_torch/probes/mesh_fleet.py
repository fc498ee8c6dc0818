"""The multi-device layer on every rank of a fleet, one rank per card,
held against one card's results on rank 0.

    torchrun --standalone --nproc-per-node 4 -m rustcv_tpu_torch.probes.mesh_fleet

Every rank runs the headline engine (``--streams`` streams of
``--width`` × ``--height`` YUYV, device-sim, ``blur_sobel``, a rect and
colour of its own per stream) on a ``stream_mesh`` in the default and
``pallas`` modes: 3 ticks gathered with ``gather_streams`` and the kernels'
launches, then ms/tick (CUDA events over 50 ticks after 5). Rank 0 holds
the gathered ticks against the meshless engine on its card. Then the rows
of a seeded gray batch are split into one band per rank and
``blur_sobel_mag_spatial`` (halos over NCCL, K1 per band) is held against
K1 on the whole batch and the plain chain. Rank 0 prints every rank's
JSON line; the probe exits 1 if anything differs. ``--device cpu`` runs
it on gloo for a rehearsal.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--streams", type=int, default=8)
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .. import parallel
    from ..capture import SimulationDriver
    from ..core import PixelFormat, SimpleConfig
    from ..ops import kernels
    from ..ops.kernels import stencil
    from ..parallel.mesh import mesh_device
    from ..runtime import MultiStreamEngine

    n, w, h = args.streams, args.width, args.height
    mesh = parallel.stream_mesh(args.device)
    rank, world, dev = dist.get_rank(), dist.get_world_size(), mesh_device(mesh)
    cuda = dev.type == "cuda"
    cfg = SimpleConfig(width=w, height=h, fps=60, pixel_format=PixelFormat.YUYV)
    rects = np.tile(np.array([[100, 100, 400, 300]], np.int32), (n, 1))
    rects[:, 0] += np.arange(n, dtype=np.int32) * 7
    colors = np.random.default_rng(0).integers(0, 256, (n, 3), np.uint8)
    res = {"rank": rank, "world": world, "device": str(dev)}

    def engine(m, mode):
        if mode == "default":
            os.environ.pop("RUSTCV_DECODE", None)
        else:
            os.environ["RUSTCV_DECODE"] = mode
        return MultiStreamEngine(SimulationDriver(device_count=n, paced=False), n, cfg,
                                 filter="blur_sobel", overlay=True, device_sim=True, mesh=m,
                                 device=args.device)

    def tick(eng):
        return eng.tick(rects=rects, rect_colors=colors)

    try:
        for mode in ("default", "pallas"):
            kernels.reset_launch_counts()
            with engine(mesh, mode) as eng:
                got = []
                for _ in range(3):
                    t = tick(eng)
                    got.append([parallel.gather_streams(t.outputs[k], mesh)
                                for k in ("bgr", "filtered")]
                               + [parallel.gather_streams(t.sequences, mesh)])
                if cuda:
                    torch.cuda.synchronize()
                res[f"launches {mode}"] = {k: v for k, v in kernels.launch_counts().items() if v}
                if cuda:
                    for _ in range(5):
                        tick(eng)
                    dist.barrier()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(50):
                        tick(eng)
                    end.record()
                    end.synchronize()
                    res[f"ms_per_tick {mode}"] = start.elapsed_time(end) / 50
            if rank == 0:
                with engine(None, mode) as ref:
                    same = True
                    for bgr, filtered, seqs in got:
                        t = tick(ref)
                        same &= torch.equal(bgr, t.outputs["bgr"])
                        same &= torch.equal(filtered, t.outputs["filtered"])
                        same &= bool((seqs == t.sequences).all())
                res[f"engine equal {mode}"] = same
            dist.barrier()

        gray = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (n, h, w), np.uint8))
        b = h // world
        kernels.reset_launch_counts()
        out = parallel.blur_sobel_mag_spatial(
            gray[:, rank * b:(rank + 1) * b].contiguous().to(dev), mesh)
        res["spatial launches"] = kernels.launch_counts()["blur_sobel_mag"]
        parts = [torch.empty_like(out) for _ in range(world)]
        dist.all_gather(parts, out)
        if rank == 0:
            whole = stencil.blur_sobel_mag(gray.to(dev))
            res["spatial equal K1"] = torch.equal(torch.cat(parts, 1), whole)
            res["spatial equal plain"] = torch.equal(whole.cpu(),
                                                     stencil.blur_sobel_mag_plain(gray))
        lines = [None] * world
        dist.all_gather_object(lines, res)
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return 0
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0 if all(v for k, v in res.items() if "equal" in k) else 1


if __name__ == "__main__":
    sys.exit(main())
