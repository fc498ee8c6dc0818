"""Multi-rank launch: every rank runs the engine over its own streams, and
one ``all_reduce`` sums the fleet's frames/s (port of
``examples/launch_distributed.py``).

Camera streams are independent, so the layout is stream data parallelism:
one rank per device, each with ``--streams-per-chip`` streams of the
headline tick (device-synthesized YUYV, ``blur_sobel``, overlay). No frame
data crosses ranks; the only collective is the float64 sum of the ranks'
frames/s.

On a host with N cards::

    torchrun --nproc-per-node N -m rustcv_tpu_torch.parallel.launch --ticks 300

One process on one card (a one-rank mesh)::

    python -m rustcv_tpu_torch.parallel.launch --ticks 20

Processes started by hand rendezvous through ``--init`` (``file://`` or
``tcp://``) with ``--rank`` and ``--world-size``. Every rank prints one JSON
line with its ``local_fps``; rank 0 then prints the fleet's: ``processes``,
``chips``, ``streams``, ``resolution``, ``local_fps`` (its own),
``fleet_fps`` and ``fps_per_stream``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--streams-per-chip", type=int, default=8)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--ticks", type=int, default=300)
    p.add_argument("--filter", default="blur_sobel")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--init", default=None,
                   help="rendezvous URL (file://path or tcp://host:port) of processes started "
                        "by hand; torchrun sets it in the environment")
    p.add_argument("--rank", type=int, default=int(os.environ.get("RANK", 0)))
    p.add_argument("--world-size", type=int, default=int(os.environ.get("WORLD_SIZE", 1)))
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..capture import SimulationDriver
    from ..core import PixelFormat, SimpleConfig
    from ..runtime import MultiStreamEngine
    from .mesh import mesh_device, stream_mesh

    if args.init is not None:
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                                init_method=args.init, rank=args.rank,
                                world_size=args.world_size)
    try:
        mesh = stream_mesh(args.device)
        n_ranks = mesh.size()
        n_streams = args.streams_per_chip * n_ranks
        eng = MultiStreamEngine(
            SimulationDriver(device_count=n_streams, paced=False), n_streams,
            SimpleConfig(width=args.width, height=args.height, fps=60,
                         pixel_format=PixelFormat.YUYV),
            filter=args.filter, overlay=True, device_sim=True, mesh=mesh, device=args.device,
        )
        try:
            rects = np.tile(np.array([[100, 100, 400, 300]], np.int32), (n_streams, 1))
            colors = np.tile(np.array([[0, 255, 0]], np.uint8), (n_streams, 1))
            stats = eng.run(args.ticks, warmup=5, measure_latency=False,
                            rects=rects, rect_colors=colors)
        finally:
            eng.close()
        local_fps = stats.fps_total
        total = torch.tensor(local_fps, dtype=torch.float64, device=mesh_device(mesh))
        dist.all_reduce(total)
        rank = dist.get_rank()
        print(json.dumps({"rank": rank, "local_fps": local_fps}), flush=True)
        if rank == 0:
            print(json.dumps({
                "processes": dist.get_world_size(),
                "chips": n_ranks,
                "streams": n_streams,
                "resolution": f"{args.width}x{args.height}",
                "local_fps": local_fps,
                "fleet_fps": float(total),
                "fps_per_stream": stats.fps_per_stream,
            }), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
