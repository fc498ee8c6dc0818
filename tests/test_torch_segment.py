"""The port's segmentation head of group 4 (``rustcv_tpu_torch.ops.ccl`` on
the native union-find, ``blob``, ``kmeans``, ``watershed``, ``slic``,
``blend.voronoi_seam``) and their ``imgproc`` names, against
``rustcv_tpu`` (JAX on the CPU) and its numpy oracles on the same seeded
inputs.

Tolerances, the reference's own (``tests/test_ccl.py``,
``test_contour_tree.py``, ``test_blob.py``, ``test_kmeans.py``,
``test_watershed.py``, ``test_slic.py``):
- exact: the components (4- and 8-connected, with stats), contours and
  the contour tree, flood fill, both distance transforms, blobs,
  watershed (the randomized parity sweep included), the Voronoi seam;
- k-means: centres within 1e-3 of the float64 oracle from the same init,
  over 99.9 % of labels equal;
- SLIC: over 97 % agreement with the float64 oracle, every disagreement
  within 3 px of an oracle boundary."""

import numpy as np
import pytest
import torch

from rustcv_tpu import imgproc as jax_ip
from rustcv_tpu.capture import simulation as sim
from rustcv_tpu.core.mat import Mat as JMat
from rustcv_tpu.ops import blend as JBl
from rustcv_tpu.ops import blob as JB
from rustcv_tpu.ops import ccl as JC
from rustcv_tpu.ops import golden as G
from rustcv_tpu.ops import kmeans as JK
from rustcv_tpu.ops import slic as JS
from rustcv_tpu.ops import watershed as JW
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch import native
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import blend as PBl
from rustcv_tpu_torch.ops import blob as PB
from rustcv_tpu_torch.ops import ccl as PC
from rustcv_tpu_torch.ops import kmeans as PK
from rustcv_tpu_torch.ops import slic as PS
from rustcv_tpu_torch.ops import watershed as PW

torch.set_num_threads(2)


def _spiral(n: int) -> np.ndarray:
    s = np.zeros((n, n), np.uint8)
    x0 = y0 = 0
    x1 = y1 = n - 1
    while x0 <= x1:
        s[y0, x0:x1 + 1] = 1
        s[y0:y1 + 1, x1] = 1
        s[y1, x0:x1 + 1] = 1
        s[y0 + 2:y1 + 1, x0] = 1
        x0 += 2
        y0 += 2
        x1 -= 2
        y1 -= 2
    return s


def _masks():
    rng = np.random.default_rng(11)
    out = {"empty": np.zeros((12, 15), np.uint8), "full": np.ones((12, 15), np.uint8),
           "diag": np.eye(12, dtype=np.uint8), "spiral": _spiral(31)}
    for d in (0.3, 0.5, 0.7):
        out[f"random{d}"] = (rng.random((48, 64)) < d).astype(np.uint8) * 255
    return out


@pytest.mark.parametrize("name", sorted(_masks()))
def test_components_are_the_references(name):
    mask = _masks()[name]
    for conn in (4, 8):
        want = JC.connected_components(mask, connectivity=conn)
        for m in (mask, torch.from_numpy(mask), torch.from_numpy(mask != 0)):
            n, lab = PC.connected_components(m, connectivity=conn)
            assert n == want[0] and np.array_equal(lab, want[1]) and lab.dtype == np.int32
    n, lab = PC.connected_components(mask, max_rounds=1)
    n2, lab2 = JC.connected_components_numpy(mask)
    assert n == n2 and np.array_equal(lab, lab2)
    assert lab.max() == n and np.all(lab[mask == 0] == 0)
    got = PC.connected_components_with_stats(torch.from_numpy(mask))
    want = JC.connected_components_with_stats(mask)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="connectivity"):
        PC.connected_components(mask, connectivity=6)


def test_components_need_the_native_build(monkeypatch):
    """No Python fallback: a native library that does not build raises
    with the compiler's output."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "g++ failed (exit 1):\nunionfind.cpp: error")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        PC.connected_components(np.ones((4, 4), np.uint8))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port_ip.connected_components(Mat.from_array(np.ones((4, 4), np.uint8), device="cpu"))


def test_stats_flood_fill_and_contours():
    mask = np.zeros((40, 60), np.uint8)
    mask[5:15, 10:20] = 255
    mask[25:30, 40:55] = 255
    n, lab, stats, cents = PC.connected_components_with_stats(mask)
    assert n == 2
    np.testing.assert_array_equal(stats[1], [10, 5, 10, 10, 100])
    np.testing.assert_allclose(cents[2], [47.0, 27.0])
    img = np.full((20, 30), 100, np.uint8)
    img[5:15, 5:20] = 50
    img[8:12, 25:28] = 50
    for seed, val, lo, up in (((10, 10), 200, 0, 0), ((0, 0), 7, 0, 0), ((3, 3), 9, 60, 10)):
        got = PC.flood_fill(torch.from_numpy(img), seed, val, lo, up)
        want = JC.flood_fill(img, seed, val, lo, up)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
    with pytest.raises(ValueError):
        PC.flood_fill(img, (99, 99), 1)
    for flags in (4, 8, 4 | (1 << 16), 8 | (255 << 8) | (1 << 17)):
        a, b = img.copy(), img.copy()
        ma, mb = np.zeros((22, 32), np.uint8), np.zeros((22, 32), np.uint8)
        ga = PC.flood_fill_cv(a, ma, (10, 10), 200, 10, 10, flags)
        gb = JC.flood_fill_cv(b, mb, (10, 10), 200, 10, 10, flags)
        assert ga[0] == gb[0] and ga[3] == gb[3]
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ma, mb)
    m = np.zeros((8, 8), np.uint8)
    m[1:4, 2:5] = 1
    (c,) = PC.find_contours(torch.from_numpy(m))
    assert c.tolist() == [[2, 1], [3, 1], [4, 1], [4, 2], [4, 3], [3, 3], [2, 3], [2, 2]]
    rng = np.random.default_rng(5)
    for _ in range(3):
        mask = (rng.random((40, 50)) > 0.6).astype(np.uint8)
        got, want = PC.find_contours(mask), JC.find_contours(mask)
        assert len(got) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _nested_scene():
    m = np.zeros((12, 14), np.uint8)
    m[2:10, 2:12] = 255
    m[4:8, 4:8] = 0
    m[5:7, 5:7] = 255
    return m


@pytest.mark.parametrize("seed", [None, 0, 3, 7])
def test_contour_tree_is_the_references(seed):
    m = (_nested_scene() if seed is None
         else (np.random.RandomState(seed).rand(48, 64) > 0.55).astype(np.uint8) * 255)
    got = PC.find_contours_tree(torch.from_numpy(m))
    want = JC.find_contours_tree(m)
    assert len(got[0]) == len(want[0]) and got[2] == want[2]
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    np.testing.assert_array_equal(got[1], want[1])
    if seed is None:
        assert got[2] == ["outer", "hole", "outer"]
    parents = np.array([-1, 0, 1, -1, 3])
    np.testing.assert_array_equal(PC.hierarchy_from_parents(parents),
                                  JC.hierarchy_from_parents(parents))
    cts, hier, kinds = PC.find_contours_tree(np.zeros((8, 8), np.uint8))
    assert cts == [] and hier.shape == (0, 4) and kinds == []


@pytest.mark.parametrize("density", [0.3, 0.7, 0.95, 1.0])
def test_distance_transforms_are_exact(jax_cpu, density):
    rng = np.random.default_rng(int(density * 100))
    mask = (rng.random((40, 56)) < density).astype(np.uint8)
    want = JC.distance_transform_l1_numpy(mask)
    got = PC.distance_transform_l1(torch.from_numpy(mask))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, JC.distance_transform_l1(mask))
    assert np.array_equal(PC.distance_transform_l1_numpy(mask), want)
    d, lab = PC.distance_transform_l2_with_labels(torch.from_numpy(mask))
    wd, wlab = JC.distance_transform_l2_with_labels(mask)
    assert np.array_equal(d, wd) and np.array_equal(lab, wlab)
    for metrics, size in (((1.0, 1.0), 3), ((0.955, 1.3693), 3), ((1.0, 1.4, 2.1969), 5)):
        assert np.array_equal(PC.distance_transform_chamfer(mask, metrics, size),
                              JC.distance_transform_chamfer(mask, metrics, size))
    m = np.ones((20, 30), np.uint8)
    m[7, 13] = 0
    ys, xs = np.mgrid[0:20, 0:30]
    assert np.array_equal(PC.distance_l1(torch.from_numpy(m)).numpy(),
                          np.abs(ys - 7) + np.abs(xs - 13))


@pytest.mark.parametrize("shape", [(0, 5), (4, 0), (0, 0)])
def test_l2_distance_of_an_empty_mask_is_the_references_empty_pair(jax_cpu, shape):
    """An empty mask gives the reference's empty float32 / int32 pair of its
    shape, for numpy and for a CPU tensor (it raised in the labeling step:
    the native scan refuses an empty mask)."""
    mask = np.zeros(shape, np.uint8)
    wd, wlab = JC.distance_transform_l2_with_labels(mask)
    for m in (mask, torch.from_numpy(mask)):
        d, lab = PC.distance_transform_l2_with_labels(m)
        assert d.dtype == wd.dtype == np.float32 and lab.dtype == wlab.dtype == np.int32
        assert d.shape == wd.shape == shape and lab.shape == wlab.shape == shape


def _blob_scene(discs, h=120, w=160, bg=220, fg=40):
    img = np.full((h, w), bg, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for (cx, cy, r) in discs:
        img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = fg
    return img


@pytest.mark.parametrize("case", ["discs", "square", "bar", "area", "bright", "noisy"])
def test_blobs_are_the_references(jax_cpu, case):
    params = PB.BlobParams()
    if case == "discs":
        img = _blob_scene([(40, 40, 10), (110, 60, 14), (70, 95, 8)])
    elif case == "square":
        img = np.full((80, 80), 220, np.uint8)
        img[20:50, 20:50] = 40
        params = PB.BlobParams(min_circularity=0.5)
    elif case == "bar":
        img = np.full((80, 120), 220, np.uint8)
        img[38:43, 20:100] = 40
        params = PB.BlobParams(min_circularity=0.0, min_convexity=0.0)
    elif case == "area":
        img = _blob_scene([(40, 40, 3), (100, 60, 12)])
        params = PB.BlobParams(min_area=50)
    elif case == "bright":
        img = _blob_scene([(60, 50, 11)], bg=30, fg=200)
        params = PB.BlobParams(blob_color=255)
    else:
        rng = np.random.default_rng(3)
        img = _blob_scene([(30, 30, 9), (90, 70, 13), (130, 40, 6)])
        img = np.clip(img.astype(int) + rng.integers(-12, 12, img.shape), 0, 255).astype(np.uint8)
    got = PB.detect_blobs(torch.from_numpy(img), params)
    want = JB.detect_blobs(img, JB.BlobParams(**params.__dict__))
    assert got.shape == want.shape and np.array_equal(got, want)
    if case == "discs":
        assert len(got) == 3
    if case == "bar":
        assert len(got) == 0


@pytest.fixture()
def clusters(rng):
    pts = np.concatenate([rng.normal((0, 0), 0.5, (200, 2)), rng.normal((10, 0), 0.5, (200, 2)),
                          rng.normal((5, 8), 0.5, (200, 2))]).astype(np.float32)
    rng.shuffle(pts)
    return pts


def test_kmeans_matches_the_oracle(jax_cpu, clusters):
    init = PK.kmeans_pp_init(torch.from_numpy(clusters), 3)
    assert np.array_equal(init, JK.kmeans_pp_init(clusters, 3))
    c, lab, inertia = PK.kmeans(torch.from_numpy(clusters), 3, iters=15, init_centers=init)
    oc, ol, oi = JK.kmeans_numpy(clusters, 3, iters=15, init_centers=init)
    assert np.abs(c.numpy() - oc).max() < 1e-3 and (lab.numpy() == ol).mean() > 0.999
    assert lab.dtype == torch.int32 and abs(float(inertia) - oi) < 1e-3 * oi
    jc, jl, _ = JK.kmeans(clusters, 3, iters=15, init_centers=init)
    assert np.abs(c.numpy() - np.asarray(jc)).max() < 1e-3
    found = sorted(tuple(np.round(cc).astype(int)) for cc in c.numpy())
    assert found == [(0, 0), (5, 8), (10, 0)]
    c2, l2, _ = PK.kmeans(torch.from_numpy(clusters), 3)
    assert torch.equal(c2, PK.kmeans(torch.from_numpy(clusters), 3)[0])
    # the subsampled init of a large tensor fetches only its sample
    big = np.random.default_rng(4).random((6000, 3)).astype(np.float32)
    assert np.array_equal(PK.kmeans_pp_init(torch.from_numpy(big), 5), JK.kmeans_pp_init(big, 5))
    oc2 = PK.kmeans_numpy(clusters, 3, 15, init)
    assert all(np.array_equal(a, b) for a, b in zip(oc2[:2], (oc, ol)))


def test_kmeans_quantize_and_wrappers(jax_cpu, clusters):
    img = sim.synth_bgr(64, 48, 3)
    q, pal = PK.kmeans_quantize(torch.from_numpy(img), k=8)
    jq, jpal = JK.kmeans_quantize(img, k=8)
    assert isinstance(q, torch.Tensor) and pal.shape == (8, 3)
    assert (q.numpy() == jq).all(-1).mean() > 0.999 and np.abs(pal.astype(int) - jpal).max() <= 1
    assert len(np.unique(q.numpy().reshape(-1, 3), axis=0)) <= 8
    dm, dpal = port_ip.kmeans_quantize(Mat.from_device(torch.from_numpy(img.copy())), k=8)
    assert dm.is_on_device and np.array_equal(dm.to_numpy(), q.numpy())
    hm, hpal = port_ip.kmeans_quantize(Mat.from_array(img, device="cpu"), k=8)
    assert not hm.is_on_device and (hm.to_numpy() == jq).all(-1).mean() > 0.999
    e8 = np.abs(hm.to_numpy().astype(int) - img).mean()
    e2 = np.abs(port_ip.kmeans_quantize(Mat.from_array(img, device="cpu"), k=2)[0]
                .to_numpy().astype(int) - img).mean()
    assert e8 < e2
    comp, lab, cen = port_ip.kmeans(torch.from_numpy(clusters), 3, iters=15)
    jcomp, jlab, jcen = jax_ip.kmeans(clusters, 3, iters=15)
    assert abs(comp - jcomp) < 1e-3 * jcomp and (lab == jlab).mean() > 0.999
    assert np.abs(cen - jcen).max() < 1e-3


def _two_basins(h=60, w=80, ridge_x=40):
    img = np.full((h, w), 40, np.uint8)
    img[:, ridge_x - 2:ridge_x + 3] = 200
    return img


def test_watershed_randomized_parity_sweep(jax_cpu):
    """Plateaus and ties everywhere (quantized intensities): exact against
    the Jacobi oracle and JAX's scans, as the reference's sweep."""
    for trial in range(12):
        rng = np.random.default_rng(trial)
        img = rng.integers(0, 6, (10, 12), np.uint8) * 50
        markers = np.zeros(img.shape, np.int32)
        for i in range(int(rng.integers(1, 5))):
            markers[rng.integers(0, 10), rng.integers(0, 12)] = i + 1
        got = PW.watershed(torch.from_numpy(img), torch.from_numpy(markers)).numpy()
        assert np.array_equal(got, JW.watershed_numpy(img, markers)), trial
        assert np.array_equal(got, JW.watershed(img, markers)), trial
        assert np.array_equal(PW.watershed_numpy(img, markers), JW.watershed_numpy(img, markers))


def test_watershed_cases(jax_cpu):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 50), np.uint8)
    markers = np.zeros(img.shape, np.int32)
    for i, (y, x) in enumerate([(5, 5), (35, 45), (20, 25), (10, 40)]):
        markers[y, x] = i + 1
    assert np.array_equal(PW.watershed(torch.from_numpy(img), markers).numpy(),
                          JW.watershed_numpy(img, markers))
    img = _two_basins()
    markers = np.zeros(img.shape, np.int32)
    markers[30, 10], markers[30, 70] = 1, 2
    out = PW.watershed(torch.from_numpy(img), markers).numpy()
    assert (out[:, :35] == 1).all() and (out[:, 46:] == 2).all()
    assert ((out == -1).sum(axis=1) >= 1).all()
    assert (PW.watershed(torch.from_numpy(img), np.zeros(img.shape, np.int32)).numpy() == 0).all()
    flat = torch.full((20, 20), 50, dtype=torch.uint8)
    markers = np.zeros((20, 20), np.int32)
    markers[5, 5], markers[15, 15] = 3, 7
    out = PW.watershed(flat, markers).numpy()
    assert out[5, 5] == 3 and out[15, 15] == 7
    moat = np.full((30, 30), 10, np.uint8)
    moat[10:20, 10:20] = 0
    moat[9:21, 9:21][np.pad(np.zeros((10, 10), bool), 1, constant_values=True)] = 255
    markers = np.zeros(moat.shape, np.int32)
    markers[0, 0] = 1
    out = PW.watershed(torch.from_numpy(moat), markers).numpy()
    assert (out != 0).all() and out[15, 15] == 1
    for bad in (np.full((8, 8), -2, np.int32), np.full((8, 8), 2**30, np.int64)):
        with pytest.raises(ValueError, match="marker labels"):
            PW.watershed(torch.zeros((8, 8), dtype=torch.uint8), bad)
    spiral = torch.from_numpy(255 - _spiral(15) * 255)
    markers = np.zeros((15, 15), np.int32)
    markers[0, 0] = 1
    with pytest.raises(ValueError, match="no fixed point"):
        PW.watershed(spiral, markers, max_rounds=1)


def test_watershed_wrapper_four_ways(jax_cpu):
    img = _two_basins(40, 60, 30)
    markers = np.zeros(img.shape, np.int32)
    markers[20, 8], markers[20, 52] = 1, 2
    want = jax_ip.watershed(JMat.from_array(img), markers)
    for mat in (Mat.from_array(img, device="cpu"), Mat.from_device(torch.from_numpy(img.copy()))):
        got = port_ip.watershed(mat, markers)
        assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    assert set(np.unique(want)) <= {-1, 1, 2}


@pytest.fixture(scope="module")
def slic_img():
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:80, 0:100]
    base = np.stack([128 + 80 * np.sin(x / 17.0), 128 + 80 * np.cos(y / 23.0),
                     64 + (x // 25 + y // 20) * 25], -1)
    return np.clip(base + rng.normal(0, 3, base.shape), 0, 255).astype(np.uint8)


def _within_boundary_band(raw_np, raw_dev):
    """Over 97 % agreement; every disagreement within 3 px of an oracle
    label boundary (the reference's contract)."""
    assert (raw_np == raw_dev).mean() > 0.97
    dis = raw_np != raw_dev
    bnd = np.zeros_like(dis)
    bnd[1:, :] |= raw_np[1:, :] != raw_np[:-1, :]
    bnd[:-1, :] |= raw_np[1:, :] != raw_np[:-1, :]
    bnd[:, 1:] |= raw_np[:, 1:] != raw_np[:, :-1]
    bnd[:, :-1] |= raw_np[:, 1:] != raw_np[:, :-1]
    for _ in range(3):
        grown = bnd.copy()
        grown[1:, :] |= bnd[:-1, :]
        grown[:-1, :] |= bnd[1:, :]
        grown[:, 1:] |= bnd[:, :-1]
        grown[:, :-1] |= bnd[:, 1:]
        bnd = grown
    assert not (dis & ~bnd).any()


@pytest.mark.parametrize("region,iters,gray", [(16, 4, False), (20, 10, False), (12, 3, True)])
def test_slic_twin_within_the_boundary_band(jax_cpu, slic_img, region, iters, gray):
    """The reference's scene in colour, and the gray test pattern (the
    reference's twin holds its own contract on both)."""
    img = (G.bgr_to_gray(sim.synth_bgr(100, 80, 3)) if gray else slic_img)
    raw_np = JS.slic_numpy(img, region_size=region, num_iterations=iters)
    assert np.array_equal(PS.slic_numpy(img, region_size=region, num_iterations=iters), raw_np)
    raw_dev = PS.slic_device(torch.from_numpy(img), region_size=region,
                             num_iterations=iters).numpy()
    assert raw_dev.dtype == np.int32
    _within_boundary_band(raw_np, raw_dev)
    raw_jax = np.asarray(JS.slic_device(img, region_size=region, num_iterations=iters))
    assert (raw_dev == raw_jax).mean() > 0.97


def test_slic_superpixels(jax_cpu, slic_img):
    labels, n = PS.slic_superpixels(torch.from_numpy(slic_img), region_size=16, num_iterations=4)
    assert labels.shape == slic_img.shape[:2] and labels.min() == 0 and labels.max() == n - 1
    assert 20 <= n <= 50
    for lab in range(n):
        assert PC.connected_components((labels == lab).astype(np.uint8))[0] == 1
    got = PS.slic_superpixels(slic_img, region_size=16, num_iterations=4)
    want = JS.slic_superpixels(slic_img, region_size=16, num_iterations=4)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])
    raw = JS.slic_numpy(slic_img, 16, 10.0, 4)
    for a, b in zip(PS.enforce_connectivity(raw, 64), JS.enforce_connectivity(raw, 64)):
        assert np.array_equal(a, b)
    u, nu = PS.slic_superpixels(slic_img, region_size=16, num_iterations=4, enforce=False)
    assert nu == JS.slic_superpixels(slic_img, region_size=16, num_iterations=4,
                                     enforce=False)[1]


def test_voronoi_seam_is_the_references():
    rng = np.random.default_rng(2)
    for _ in range(3):
        m1 = np.zeros((40, 60), np.uint8)
        m2 = np.zeros((40, 60), np.uint8)
        y0, x0 = rng.integers(0, 15, 2)
        m1[y0:, :int(rng.integers(30, 50))] = 255
        m2[:int(rng.integers(25, 40)), x0 + 10:] = 1
        got = PBl.voronoi_seam(torch.from_numpy(m1), m2)
        want = JBl.voronoi_seam(m1, m2)
        assert all(np.array_equal(a, b) and a.dtype == bool for a, b in zip(got, want))
        assert not (got[0] & got[1]).any()
        assert np.array_equal(got[0] | got[1], (m1 > 0) | (m2 > 0))
    assert port_ip.voronoi_seam is PBl.voronoi_seam


def test_segmentation_wrappers_four_ways(jax_cpu):
    """The ``imgproc`` names on the port's host Mat and CPU-tensor Mat
    against the reference's host and JAX Mats."""
    img = np.zeros((60, 80, 3), np.uint8)
    img[10:20, 10:25] = (0, 0, 255)
    img[35:50, 40:70] = (0, 0, 255)
    img[52:58, 5:12] = (0, 0, 255)
    mask = ((img[..., 2] > 0) * 255).astype(np.uint8)
    ports = (Mat.from_array(mask, device="cpu"), Mat.from_device(torch.from_numpy(mask.copy())))
    refs = (JMat.from_array(mask), JMat.from_array(mask))
    refs[1].device()
    for p, r in zip(ports, refs):
        got, want = port_ip.connected_components(p), jax_ip.connected_components(r)
        assert got[0] == want[0] == 3 and np.array_equal(got[1], np.asarray(want[1]))
        got = port_ip.connected_components_with_stats(p)
        want = jax_ip.connected_components_with_stats(r)
        assert all(np.array_equal(a, b) for a, b in zip(got[1:], want[1:]))
        got, want = port_ip.find_contours(p), jax_ip.find_contours(r)
        assert all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got) == 3
        got, want = port_ip.distance_transform(p), jax_ip.distance_transform(r)
        assert isinstance(got, np.ndarray) and np.array_equal(got, want)
        out, cnt, fmask = port_ip.flood_fill(p, (15, 15), 9)
        wout, wcnt, wmask = jax_ip.flood_fill(r, (15, 15), 9)
        assert cnt == wcnt and out.is_on_device == p.is_on_device
        assert np.array_equal(out.to_numpy()[..., 0], wout.to_numpy()[..., 0])
        assert np.array_equal(fmask, wmask)
    blobs = _blob_scene([(50, 40, 9)])
    for p in (Mat.from_array(blobs, device="cpu"), Mat.from_device(torch.from_numpy(blobs.copy()))):
        got = port_ip.detect_blobs(p)
        assert np.array_equal(got, jax_ip.detect_blobs(JMat.from_array(blobs))) and len(got) == 1
    d, lab = port_ip.distance_transform_l2_with_labels(mask)
    wd, wlab = jax_ip.distance_transform_l2_with_labels(mask)
    assert np.array_equal(d, wd) and np.array_equal(lab, wlab)
    assert port_ip.slic_superpixels is PS.slic_superpixels
