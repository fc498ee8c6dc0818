"""The port's multi-device layer (``rustcv_tpu_torch.parallel`` and the
engine's ``mesh=``) against the JAX package on the 8-device virtual CPU
mesh, exact (max |diff| 0).

Multi-rank cases run as 2- and 4-process gloo groups (``_WORKER``, one rank
per process, rendezvous through a ``file://`` in the test's temporary
directory), each group under its own timeout; every rank gathers the
results (``gather_streams``, ``all_gather``) and pickles them, and the
tests hold rank 0's against the JAX package's on the same seeded inputs and
against the port without a mesh. One-rank meshes run in this process.
The launchers (``parallel.launch``, ``parallel.rehearse_2d``) run as the
processes of a fleet would.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import rustcv_tpu.core as jax_core
from rustcv_tpu import parallel as jpar
from rustcv_tpu.capture import SimulationDriver as JaxDriver
from rustcv_tpu.ops import golden
from rustcv_tpu.runtime import MultiStreamEngine as JaxEngine
from rustcv_tpu_torch import native, parallel
from rustcv_tpu_torch.capture import SimulationDriver
from rustcv_tpu_torch.core import PixelFormat, SimpleConfig
from rustcv_tpu_torch.ops.filters import blur_sobel_mag_u8
from rustcv_tpu_torch.parallel.spatial import HALO, band_blur_sobel
from rustcv_tpu_torch.runtime import MultiStreamEngine

REPO = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 300  # one multi-rank group, spawn to exit
SEED = 20260817
N_STREAMS, W, H = 8, 64, 48
SPATIAL_SHAPES = ((2, 64, 96), (1, 1080, 256), (3, 48, 64))
SPATIAL_2D_SHAPES = ((4, 64, 96), (8, 32, 64))
ENGINE_CASES = tuple((f, sim) for f in ("sobel_mag", "blur_sobel") for sim in (True, False))
TICKS = 2

_WORKER = textwrap.dedent('''
    import pickle, sys
    rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.core import PixelFormat, SimpleConfig
    from rustcv_tpu_torch.parallel import (
        blur_sobel_mag_spatial, blur_sobel_mag_spatial_2d, corner_counts_psum, gather_streams,
        grid_mesh, shard_batch, stream_mesh)
    from rustcv_tpu_torch.runtime import MultiStreamEngine

    SEED, N, W, H, TICKS = {seed}, {n}, {w}, {h}, {ticks}
    res = {{}}

    def frames(shape):
        return np.random.default_rng(SEED).integers(0, 256, shape, np.uint8)

    def raises(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    def gather_all(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return parts

    # 1-D row bands: band r of every frame on rank r
    rows = stream_mesh("cpu", axis="rows")
    for shape in {spatial}:
        b = shape[1] // world
        band = torch.from_numpy(frames(shape)[:, rank * b:(rank + 1) * b].copy())
        res[("spatial", shape)] = torch.cat(gather_all(blur_sobel_mag_spatial(band, rows)), 1).numpy()
    zeros = lambda n, h: torch.zeros((n, h, 16), dtype=torch.uint8)
    res[("error", "height")] = raises(lambda: blur_sobel_mag_spatial(zeros(1, 8 + (rank > 0)), rows))
    res[("error", "halo")] = raises(lambda: blur_sobel_mag_spatial(zeros(1, 2), rows))
    res[("error", "grid")] = raises(lambda: grid_mesh(world + 1, 1, "cpu"))
    res[("error", "shard_batch")] = raises(lambda: shard_batch(np.zeros((world + 1, 4)), rows))

    # 2-D: stream group s and band r on the rank at (s, r)
    if world == 4:
        grid = grid_mesh(2, 2, "cpu")
        s, r = grid.get_local_rank(0), grid.get_local_rank(1)
        for shape in {spatial_2d}:
            n, b = shape[0] // 2, shape[1] // 2
            block = torch.from_numpy(frames(shape)[s * n:(s + 1) * n, r * b:(r + 1) * b].copy())
            parts = gather_all(blur_sobel_mag_spatial_2d(block, grid))
            full = np.zeros(shape, np.uint8)
            for k, part in enumerate(parts):
                ks, kr = divmod(k, 2)
                full[ks * n:(ks + 1) * n, kr * b:(kr + 1) * b] = part.numpy()
            res[("spatial_2d", shape)] = full
        res[("error", "batch_2d")] = raises(
            lambda: blur_sobel_mag_spatial_2d(zeros(1 + (s > 0), 8), grid))

    # the engine over the stream axis
    mesh = stream_mesh("cpu")
    rng = np.random.default_rng(SEED)
    rects = np.stack([rng.integers(-10, 40, N), rng.integers(-10, 30, N),
                      rng.integers(0, 60, N), rng.integers(0, 50, N)], 1).astype(np.int32)
    colors = rng.integers(0, 256, (N, 3), np.uint8)
    cfg = SimpleConfig(width=W, height=H, fps=60, pixel_format=PixelFormat.YUYV)

    def engine(n=N, fmt_cfg=cfg, **kw):
        return MultiStreamEngine(SimulationDriver(device_count=n, paced=False), n, fmt_cfg,
                                 mesh=mesh, device="cpu", **kw)

    def ticks(eng, k=TICKS, keys=("bgr", "filtered"), **kw):
        out = []
        for _ in range(k):
            t = eng.tick(block=True, **kw)
            out.append({{key: gather_streams(t.outputs[key], mesh).numpy() for key in keys}}
                       | {{"seqs": gather_streams(t.sequences, mesh)}})
        return out

    for filt, sim in {engine_cases}:
        with engine(filter=filt, overlay=True, device_sim=sim) as eng:
            res[("engine", filt, sim)] = ticks(eng, rects=rects, rect_colors=colors)
            res[("local", filt, sim)] = (eng.n, eng.first_stream)
    with engine(filter="blur_sobel", overlay=True, device_sim=True) as eng:
        res["text"] = ticks(eng, 1, rects=rects, rect_colors=colors,
                            text=[f"cam {{i}}" for i in range(N)])
        stats = eng.run_chained(4, chain=2, rects=rects, rect_colors=colors)
        res["chained"] = (stats.frames, ticks(eng, 1, rects=rects, rect_colors=colors))
    mjpeg = SimpleConfig(width=W, height=H, fps=30, pixel_format=PixelFormat.MJPEG)
    for backend in ("hybrid", "host"):
        with engine(fmt_cfg=mjpeg, filter="blur_sobel", mjpeg_backend=backend) as eng:
            res[("mjpeg", backend)] = ticks(eng)
    with engine(filter="none", overlay=False, encode_jpeg_quality=88) as eng:
        payloads = [None] * world
        dist.all_gather_object(payloads, eng.encode_payloads(eng.tick(block=True)))
        res["payloads"] = [p for part in payloads for p in part]
        streamed = []
        for _, local in eng.stream_encoded(max_ticks=2):
            parts = [None] * world
            dist.all_gather_object(parts, local)
            streamed.append([p for part in parts for p in part])
        res["streamed"] = streamed
        res["run_encoded_frames"] = eng.run_encoded(2, warmup=0)[0].frames

    mask = np.zeros((N, 16, 16), bool)
    mask[:, 4, 4] = True
    mask[0, 8, 8] = True
    res["psum"] = int(corner_counts_psum(shard_batch(mask, mesh), mesh))

    with MultiStreamEngine(SimulationDriver(device_count=N, paced=False), N, cfg,
                           filter="blur_sobel", overlay=True, device_sim=True,
                           device="cpu") as eng:
        state = eng.export_state()
    state["sequences"] = [5 + 3 * i for i in range(N)]
    with MultiStreamEngine.from_state(state, device="cpu", mesh=mesh) as eng:
        local = eng.export_state()
        res["from_state"] = (gather_streams(np.array(local["sequences"]), mesh),
                             local["n_streams"], ticks(eng, 1, rects=rects, rect_colors=colors))

    res[("error", "n_streams")] = raises(lambda: engine(n=N + 1, device_sim=True))
    res[("error", "sub_batch")] = raises(lambda: engine(device_sim=True, sub_batch=2))
    with open(f"{{out}}/rank{{rank}}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    print("OK")
''').format(seed=SEED, n=N_STREAMS, w=W, h=H, ticks=TICKS, spatial=repr(SPATIAL_SHAPES),
            spatial_2d=repr(SPATIAL_2D_SHAPES), engine_cases=repr(ENGINE_CASES))


def _spawn(argv, world: int, workdir: Path, timeout: float = GROUP_TIMEOUT_S) -> list:
    """Start ``world`` processes (``argv(rank, init_url)``) as one gloo group
    rendezvousing through a file in ``workdir``; returns each one's (rc,
    stdout, stderr). The group shares one deadline; on expiry, or any
    error, every process still running is killed."""
    init = f"file://{workdir / 'pg_init'}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, *argv(r, init)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}\n{out[-2000:]}\n{err[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """world → every rank's results of ``_WORKER``, run once per world."""
    native.available()  # build the coder once, before the ranks load it
    runs = {}

    def get(world: int) -> list:
        if world not in runs:
            d = tmp_path_factory.mktemp(f"fleet{world}")
            _spawn(lambda r, init: ["-c", _WORKER, str(r), str(world), init, str(d)], world, d)
            runs[world] = [pickle.loads((d / f"rank{r}.pkl").read_bytes()) for r in range(world)]
        return runs[world]

    return get


@pytest.fixture(scope="module")
def one_rank():
    """The one-rank gloo group that ``stream_mesh("cpu")`` starts in this
    process, taken down after the module."""
    mesh = parallel.stream_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def _frames(shape):
    return np.random.default_rng(SEED).integers(0, 256, shape, np.uint8)


def _golden(g):
    return np.stack([golden.gradient_magnitude_u8(*golden.sobel3_gray(golden.gaussian5_u8(x)))
                     for x in g])


def _overlay():
    rng = np.random.default_rng(SEED)
    n = N_STREAMS
    rects = np.stack([rng.integers(-10, 40, n), rng.integers(-10, 30, n),
                      rng.integers(0, 60, n), rng.integers(0, 50, n)], 1).astype(np.int32)
    return rects, rng.integers(0, 256, (n, 3), np.uint8)


def _cfg(pkg=None, fmt="YUYV", fps=60):
    from rustcv_tpu_torch import core

    pkg = pkg or core
    return pkg.SimpleConfig(width=W, height=H, fps=fps, pixel_format=pkg.PixelFormat[fmt])


def _port_ticks(k=TICKS, keys=("bgr", "filtered"), fmt="YUYV", fps=60, tick_kw=None, **kw):
    eng = MultiStreamEngine(SimulationDriver(device_count=N_STREAMS, paced=False), N_STREAMS,
                            _cfg(fmt=fmt, fps=fps), device="cpu", **kw)
    with eng:
        return [_fetch(eng.tick(block=True, **(tick_kw or {})), keys) for _ in range(k)]


def _fetch(res, keys):
    return {key: np.asarray(res.outputs[key]) for key in keys} | {"seqs": np.asarray(res.sequences)}


def _assert_ticks(got, want, what):
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), what
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"{what}: tick {t} {key}")


# -- row bands: the route onto K1, alone ----------------------------------------


def _band_cases():
    for shape in ((2, 24, 17), (1, 36, 5), (3, 9, 40), (1, 1080, 32)):
        for r in range(1, shape[1] // HALO + 1):
            if shape[1] % r == 0:
                yield shape, r


@pytest.mark.parametrize("shape,n_bands", list(_band_cases()))
def test_band_halos_and_crop_equal_the_whole_frame(shape, n_bands):
    """Each band with its true neighbour rows (HALO each side, none at a
    global edge) through the plain chain, cropped, equals the whole frame's
    result and golden's, for every band count with bands >= HALO rows."""
    g = torch.from_numpy(_frames(shape))
    b = shape[1] // n_bands
    out = []
    for r in range(n_bands):
        lo, hi = r * b, (r + 1) * b
        top = g[:, lo - HALO:lo] if r > 0 else None
        bot = g[:, hi:hi + HALO] if r < n_bands - 1 else None
        out.append(band_blur_sobel(g[:, lo:hi], top, bot))
    got = torch.cat(out, 1)
    assert torch.equal(got, blur_sobel_mag_u8(g))
    np.testing.assert_array_equal(got.numpy(), _golden(g.numpy()))


# -- spatial stencil on 2 and 4 ranks -------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("shape", SPATIAL_SHAPES)
def test_spatial_1d_matches_jax_and_golden(fleet, jax_cpu, world, shape):
    g = _frames(shape)
    want = np.asarray(jpar.blur_sobel_mag_spatial(
        jax.numpy.asarray(g), jpar.stream_mesh(jax.devices()[:world], axis="rows")))
    np.testing.assert_array_equal(want, _golden(g))
    for rank, res in enumerate(fleet(world)):
        np.testing.assert_array_equal(res[("spatial", shape)], want, err_msg=f"rank {rank}")


@pytest.mark.parametrize("shape", SPATIAL_2D_SHAPES)
def test_spatial_2d_matches_jax_and_golden(fleet, jax_cpu, shape):
    g = _frames(shape)
    want = np.asarray(jpar.blur_sobel_mag_spatial_2d(
        jax.numpy.asarray(g), jpar.grid_mesh(2, 2, jax.devices()[:4])))
    np.testing.assert_array_equal(want, _golden(g))
    for rank, res in enumerate(fleet(4)):
        np.testing.assert_array_equal(res[("spatial_2d", shape)], want, err_msg=f"rank {rank}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["height", "halo", "grid", "shard_batch", "n_streams",
                                  "sub_batch"])
def test_multi_rank_value_errors(fleet, jax_cpu, world, case):
    """Every rank raises ValueError where the JAX package does on the global
    array: an indivisible height (bands of 8 and 9 rows), bands under
    HALO, a grid the world does not fill, a batch or stream count that does
    not divide over the mesh, ``sub_batch`` with a mesh."""
    devs = jax.devices()[:world]
    jax_call = {
        "height": lambda: jpar.blur_sobel_mag_spatial(
            np.zeros((1, 8 * world + 1, 16), np.uint8), jpar.stream_mesh(devs, axis="rows")),
        "halo": lambda: jpar.blur_sobel_mag_spatial(
            np.zeros((1, 2 * world, 16), np.uint8), jpar.stream_mesh(devs, axis="rows")),
        "grid": lambda: jpar.grid_mesh(world + 1, 1, devs),
        "shard_batch": lambda: jpar.shard_batch(np.zeros((world + 1, 4)), jpar.stream_mesh(devs)),
        "n_streams": lambda: JaxEngine(JaxDriver(device_count=N_STREAMS + 1, paced=False),
                                       N_STREAMS + 1, _cfg(jax_core), device_sim=True,
                                       mesh=jpar.stream_mesh(devs)),
        "sub_batch": lambda: JaxEngine(JaxDriver(device_count=N_STREAMS, paced=False), N_STREAMS,
                                       _cfg(jax_core), device_sim=True, sub_batch=2,
                                       mesh=jpar.stream_mesh(devs)),
    }[case]
    with pytest.raises(ValueError):
        jax_call()
    for rank, res in enumerate(fleet(world)):
        assert res[("error", case)] is not None, f"rank {rank} did not raise for {case}"


def test_2d_batch_that_does_not_divide_raises(fleet, jax_cpu):
    with pytest.raises(ValueError):
        jpar.blur_sobel_mag_spatial_2d(np.zeros((3, 16, 16), np.uint8),
                                       jpar.grid_mesh(2, 2, jax.devices()[:4]))
    assert all(res[("error", "batch_2d")] is not None for res in fleet(4))


# -- the engine on 2 and 4 ranks ------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("filt,device_sim", ENGINE_CASES)
def test_mesh_engine_matches_jax_mesh_and_meshless(fleet, jax_cpu, world, filt, device_sim):
    rects, colors = _overlay()
    jeng = JaxEngine(JaxDriver(device_count=N_STREAMS, paced=False), N_STREAMS, _cfg(jax_core),
                     filter=filt, overlay=True, device_sim=device_sim, mesh=jpar.stream_mesh())
    try:
        want = [_fetch(jeng.tick(rects=rects, rect_colors=colors, block=True),
                       ("bgr", "filtered")) for _ in range(TICKS)]
    finally:
        jeng.close()
    meshless = _port_ticks(filter=filt, overlay=True, device_sim=device_sim,
                           tick_kw={"rects": rects, "rect_colors": colors})
    _assert_ticks(meshless, want, "meshless port vs JAX mesh")
    k = N_STREAMS // world
    for rank, res in enumerate(fleet(world)):
        assert res[("local", filt, device_sim)] == (k, rank * k)
        _assert_ticks(res[("engine", filt, device_sim)], want, f"rank {rank} of {world}")


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_engine_text_and_chained(fleet, world):
    rects, colors = _overlay()
    text = [f"cam {i}" for i in range(N_STREAMS)]
    kw = dict(filter="blur_sobel", overlay=True, device_sim=True)
    want = _port_ticks(1, tick_kw={"rects": rects, "rect_colors": colors, "text": text}, **kw)
    eng = MultiStreamEngine(SimulationDriver(device_count=N_STREAMS, paced=False), N_STREAMS,
                            _cfg(), device="cpu", **kw)
    with eng:
        eng.tick(rects=rects, rect_colors=colors, text=text)
        stats = eng.run_chained(4, chain=2, rects=rects, rect_colors=colors)
        chained = [_fetch(eng.tick(rects=rects, rect_colors=colors, block=True),
                          ("bgr", "filtered"))]
    for res in fleet(world):
        _assert_ticks(res["text"], want, "text")
        frames, ticks = res["chained"]
        assert frames == stats.frames // world
        _assert_ticks(ticks, chained, "after run_chained")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("backend", ["hybrid", "host"])
def test_mesh_engine_mjpeg_matches_meshless(fleet, world, backend):
    want = _port_ticks(fmt="MJPEG", fps=30, filter="blur_sobel", mjpeg_backend=backend)
    for res in fleet(world):
        _assert_ticks(res[("mjpeg", backend)], want, f"MJPEG {backend}")


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_payloads_equal_the_meshless_engines(fleet, world):
    """Each rank codes its own streams; gathered, the JFIF bytes equal the
    meshless engine's byte for byte (tests/test_runtime.py:191-214)."""
    if not native.available():
        pytest.fail(f"the port's coder did not build: {native.build_error()}")
    eng = MultiStreamEngine(SimulationDriver(device_count=N_STREAMS, paced=False), N_STREAMS,
                            _cfg(), filter="none", overlay=False, encode_jpeg_quality=88,
                            device="cpu")
    with eng:
        want = eng.encode_payloads(eng.tick(block=True))
        streamed = [p for _, p in eng.stream_encoded(max_ticks=2)]
    for res in fleet(world):
        assert res["payloads"] == want
        assert res["streamed"] == streamed
        assert res["run_encoded_frames"] == 2 * N_STREAMS // world


@pytest.mark.parametrize("world", [2, 4])
def test_psum_and_from_state_on_the_fleet(fleet, jax_cpu, world):
    mask = np.zeros((N_STREAMS, 16, 16), bool)
    mask[:, 4, 4] = True
    mask[0, 8, 8] = True
    jmesh = jpar.stream_mesh()
    assert int(jpar.corner_counts_psum(jpar.shard_batch(mask, jmesh), jmesh)) == 9
    rects, colors = _overlay()
    seqs = [5 + 3 * i for i in range(N_STREAMS)]
    with MultiStreamEngine(SimulationDriver(device_count=N_STREAMS, paced=False), N_STREAMS,
                           _cfg(), filter="blur_sobel", overlay=True, device_sim=True,
                           device="cpu") as eng:
        state = eng.export_state() | {"sequences": seqs}
    with MultiStreamEngine.from_state(state, device="cpu") as eng:
        want = [_fetch(eng.tick(rects=rects, rect_colors=colors, block=True),
                       ("bgr", "filtered"))]
    assert list(want[0]["seqs"]) == seqs
    for res in fleet(world):
        assert res["psum"] == 9
        gathered, n_streams, ticks = res["from_state"]
        assert list(gathered) == seqs and n_streams == N_STREAMS
        _assert_ticks(ticks, want, "from_state")


# -- the launchers ---------------------------------------------------------------


def test_launcher_sums_the_fleet(tmp_path):
    """``parallel.launch`` on 2 gloo ranks: the fleet's frames/s is the
    float64 sum of the ranks' own (equalities only)."""
    outs = _spawn(lambda r, init: [
        "-m", "rustcv_tpu_torch.parallel.launch", "--device", "cpu", "--width", "64",
        "--height", "48", "--streams-per-chip", "2", "--ticks", "3", "--init", init,
        "--rank", str(r), "--world-size", "2"], 2, tmp_path)
    lines = [[json.loads(x) for x in out.splitlines() if x.startswith("{")] for _, out, _ in outs]
    local = [ls[0]["local_fps"] for ls in lines]
    assert [ls[0]["rank"] for ls in lines] == [0, 1] and len(lines[1]) == 1
    summary = lines[0][-1]
    assert summary["processes"] == 2 and summary["chips"] == 2 and summary["streams"] == 4
    assert summary["resolution"] == "64x48" and summary["local_fps"] == local[0]
    assert summary["fleet_fps"] == pytest.approx(sum(local), rel=1e-15, abs=0)


def test_rehearse_2d_crosses_processes(tmp_path):
    """``parallel.rehearse_2d`` on 4 ranks (2 × 2): every band bit-exact,
    and each band took a halo from every row neighbour, all in other
    processes: S · 2(R − 1) = 4 edges."""
    outs = _spawn(lambda r, init: [
        "-m", "rustcv_tpu_torch.parallel.rehearse_2d", "--device", "cpu", "--rows", "2",
        "--init", init, "--rank", str(r), "--world-size", "4"], 4, tmp_path)
    recs = [json.loads(next(x for x in out.splitlines() if x.startswith("{")))
            for _, out, _ in outs]
    assert sorted(rec["process"] for rec in recs) == [0, 1, 2, 3]
    for rec in recs:
        assert rec["chips"] == 4 and rec["mesh"] == [2, 2] and rec["bit_exact"] is True
        assert rec["max_abs_diff"] == 0 and rec["cross_process_halo_edges"] == 1
    assert sum(rec["cross_process_halo_edges"] for rec in recs) == 4


# -- one rank, in this process ---------------------------------------------------


def test_one_rank_mesh_engine_equals_meshless(one_rank):
    rects, colors = _overlay()
    kw = dict(filter="blur_sobel", overlay=True, device_sim=True)
    want = _port_ticks(tick_kw={"rects": rects, "rect_colors": colors}, **kw)
    eng = MultiStreamEngine(SimulationDriver(device_count=N_STREAMS, paced=False), N_STREAMS,
                            _cfg(), mesh=one_rank, device="cpu", **kw)
    with eng:
        assert (eng.n, eng.first_stream, eng.n_streams) == (N_STREAMS, 0, N_STREAMS)
        got = []
        for _ in range(TICKS):
            res = eng.tick(rects=rects, rect_colors=colors, block=True)
            got.append({k: parallel.gather_streams(res.outputs[k], one_rank).numpy()
                        for k in ("bgr", "filtered")}
                       | {"seqs": parallel.gather_streams(res.sequences, one_rank)})
    _assert_ticks(got, want, "one-rank mesh")


def test_one_rank_psum_and_placements(one_rank, jax_cpu):
    mask = np.zeros((N_STREAMS, 16, 16), bool)
    mask[:, 4, 4] = True
    mask[0, 8, 8] = True
    sharded = parallel.shard_batch(mask, one_rank)
    assert tuple(sharded.to_local().shape) == mask.shape
    total = parallel.corner_counts_psum(sharded, one_rank)
    assert total.dtype == torch.int32 and total.ndim == 0 and int(total) == 9
    assert int(parallel.corner_counts_psum(torch.from_numpy(mask), one_rank)) == 9
    from torch.distributed.tensor import Replicate, Shard

    assert parallel.stream_sharding(one_rank) == [Shard(0)]
    assert parallel.replicated(one_rank) == [Replicate()]
    grid = parallel.grid_mesh(1, 1, "cpu")
    assert grid.mesh_dim_names == ("stream", "rows")
    assert parallel.stream_sharding(grid) == [Shard(0), Replicate()]
    assert parallel.replicated(grid) == [Replicate(), Replicate()]


def test_one_rank_spatial_and_its_checks(one_rank, jax_cpu):
    g = _frames((2, 64, 96))
    rows = parallel.stream_mesh("cpu", axis="rows")
    grid = parallel.grid_mesh(1, 1, "cpu")
    out = parallel.blur_sobel_mag_spatial(torch.from_numpy(g), rows)
    np.testing.assert_array_equal(out.numpy(), _golden(g))
    out2 = parallel.blur_sobel_mag_spatial(torch.from_numpy(g[0]), rows)  # [H, W]
    np.testing.assert_array_equal(out2.numpy(), _golden(g)[0])
    np.testing.assert_array_equal(
        parallel.blur_sobel_mag_spatial_2d(torch.from_numpy(g), grid).numpy(), _golden(g))
    # the wrong mesh rank, and a band under HALO, raise as in the JAX package
    jrows = jpar.stream_mesh(jax.devices()[:2], axis="rows")
    jgrid = jpar.grid_mesh(2, 2, jax.devices()[:4])
    for port_call, jax_call in (
            (lambda: parallel.blur_sobel_mag_spatial(torch.from_numpy(g), grid),
             lambda: jpar.blur_sobel_mag_spatial(g, jgrid)),
            (lambda: parallel.blur_sobel_mag_spatial_2d(torch.from_numpy(g), rows),
             lambda: jpar.blur_sobel_mag_spatial_2d(g, jrows)),
            (lambda: parallel.blur_sobel_mag_spatial(torch.from_numpy(g[:, :2]), rows),
             lambda: jpar.blur_sobel_mag_spatial(g[:, :4], jrows))):
        with pytest.raises(ValueError):
            jax_call()
        with pytest.raises(ValueError):
            port_call()


def test_one_rank_engine_checks(one_rank):
    cfg = _cfg()
    drv = SimulationDriver(device_count=N_STREAMS, paced=False)
    with pytest.raises(ValueError, match="sub_batch"):
        MultiStreamEngine(drv, N_STREAMS, cfg, device_sim=True, sub_batch=4, mesh=one_rank,
                          device="cpu")
    with pytest.raises(ValueError, match="rank's device"):  # a CPU mesh, the default "cuda"
        MultiStreamEngine(drv, N_STREAMS, cfg, device_sim=True, mesh=one_rank)
    with MultiStreamEngine(drv, N_STREAMS, cfg, device_sim=True, device="cpu") as eng:
        state = eng.export_state()
    with pytest.raises(ValueError, match="stream positions"):
        MultiStreamEngine.from_state(state | {"sequences": [0] * (N_STREAMS - 1)},
                                     device="cpu", mesh=one_rank)
    with MultiStreamEngine.from_state(state | {"sequences": list(range(N_STREAMS))},
                                      device="cpu", mesh=one_rank) as eng:
        assert eng.export_state()["sequences"] == list(range(N_STREAMS))
        assert list(eng.tick(block=True).sequences) == list(range(N_STREAMS))


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    """No path drops to the CPU: a ``"cuda"`` mesh where CUDA is absent
    raises before any process group is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.stream_mesh("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.grid_mesh(1, 1, "cuda")
    with pytest.raises(ValueError, match="device_type"):
        parallel.stream_mesh("tpu")


def test_gather_streams_keeps_the_kind(one_rank):
    a = np.arange(12, dtype=np.int64).reshape(4, 3)
    got = parallel.gather_streams(a, one_rank)
    assert isinstance(got, np.ndarray) and (got == a).all()
    t = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    assert torch.equal(parallel.gather_streams(t, one_rank), t)
