"""Cross-process 2-D (streams × rows) stencil rehearsal (port of
``examples/rehearse_2d_distributed.py``).

Each rank runs :func:`~rustcv_tpu_torch.parallel.blur_sobel_mag_spatial_2d`
on its block of a seeded batch: one frame per stream group, band r of its
rows on the rank at ``(s, r)`` of a ``grid_mesh``. With one rank per
device, every rows neighbour is another process, so every halo crosses a
process boundary: a band's 3 edge rows can equal the golden chain only if
its neighbours' rows arrived. Each rank checks its band against the plain
chain on the whole frame and prints one JSON line (``bit_exact``,
``cross_process_halo_edges``: the halos its band received); it exits 1 if
its band differs.

    torchrun --nproc-per-node 4 -m rustcv_tpu_torch.parallel.rehearse_2d --rows 2

or, with processes started by hand, ``--init file://path --rank r
--world-size n --device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

SEED = 20260820  # the reference rehearsal's input seed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=2, help="ranks per frame (the rows axis)")
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--init", default=None,
                   help="rendezvous URL of processes started by hand (file:// or tcp://)")
    p.add_argument("--rank", type=int, default=int(os.environ.get("RANK", 0)))
    p.add_argument("--world-size", type=int, default=int(os.environ.get("WORLD_SIZE", 1)))
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..ops.filters import blur_sobel_mag_u8
    from .mesh import grid_mesh, mesh_device
    from .spatial import blur_sobel_mag_spatial_2d

    if args.init is not None:
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                                init_method=args.init, rank=args.rank,
                                world_size=args.world_size)
    try:
        n_rows = args.rows
        if args.world_size % n_rows:
            raise ValueError(f"--rows {n_rows} does not divide the {args.world_size} ranks")
        mesh = grid_mesh(args.world_size // n_rows, n_rows, args.device)
        n_streams = mesh.size(0)
        s, r = mesh.get_local_rank(0), mesh.get_local_rank(1)
        if args.height % n_rows:
            raise ValueError(f"--height {args.height} does not divide over {n_rows} bands")
        band = args.height // n_rows
        # The same seeded batch on every rank; each takes its block.
        frames = np.random.default_rng(SEED).integers(
            0, 256, (n_streams, args.height, args.width), np.uint8)
        block = torch.from_numpy(frames[s:s + 1, r * band:(r + 1) * band].copy())
        got = blur_sobel_mag_spatial_2d(block.to(mesh_device(mesh)), mesh).cpu()
        want = blur_sobel_mag_u8(torch.from_numpy(frames[s:s + 1]))[:, r * band:(r + 1) * band]
        exact = torch.equal(got, want)
        print(json.dumps({
            "process": dist.get_rank(),
            "processes": dist.get_world_size(),
            "chips": mesh.size(),
            "mesh": [n_streams, n_rows],
            "bit_exact": exact,
            "max_abs_diff": int((got.int() - want.int()).abs().max()),
            "shards_checked": 1,
            "cross_process_halo_edges": int(r > 0) + int(r < n_rows - 1),
        }), flush=True)
        return 0 if exact else 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
