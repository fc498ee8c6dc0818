"""The GIF writer's quantizer (``rustcv_tpu_torch.imgcodecs.quantize``)
against Pillow 12.1's median cut, what the reference's GIF writes reach
through ``convert("P", palette=Image.Palette.ADAPTIVE)``.

* Seeded frames of every kind (noise, few colours, gradients, palettes,
  256 colours or fewer): the palette (entries and order) and the index map
  equal Pillow's, byte for byte.
* One test per rule of Quant.c the port follows, each on a few colours set
  among 256 - n heavier ones that every cut splits off first, so that they
  end in n boxes (:func:`_among_fillers`): the coarse hash above
  65,536 colours, the split order by pixel count, the weighted widest
  axis (and its tie), the median run kept whole (and the lowest run),
  the entries' half-up rounding, the mapping's tie to the box's entry and
  its search order, frames of 256 colours or fewer through the cut.
* The committed hashes of ``tests/data/gif/quant_refs.json``
  (``tools/make_quant_refs.py``), which phase 3z holds the card to, are
  Pillow's and the port's; a GIF the port writes reads back as the
  reference's does, pixel for pixel.
"""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as S
from rustcv_tpu import imgcodecs as jax_codecs
from rustcv_tpu.core import Mat as JMat
from rustcv_tpu_torch import imgcodecs
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.imgcodecs import quantize

REFS = Path(__file__).resolve().parent / "data" / "gif" / "quant_refs.json"


def _pillow(frame):
    """Pillow's (index map, palette (m, 3)) of an RGB u8 frame."""
    im = Image.fromarray(frame).convert("P", palette=Image.Palette.ADAPTIVE)
    return np.asarray(im), np.array(im.getpalette(), np.uint8).reshape(-1, 3)


def _same_as_pillow(frame):
    idx, pal = quantize.quantize(frame)
    want_idx, want_pal = _pillow(frame)
    assert pal.shape == want_pal.shape and np.array_equal(pal, want_pal)
    assert idx.dtype == np.uint8 and np.array_equal(idx, want_idx)
    return idx, pal


def _frame(seed: int):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(4, 72, 2))
    kind = seed % 6
    if kind == 0:
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == 1:
        return (rng.integers(0, 8, (h, w, 3)) * 36).astype(np.uint8)
    if kind == 2:
        y, x = np.mgrid[0:h, 0:w]
        g = np.stack([x * 255 // w, y * 255 // h, (x + y) % 256], -1)
        return np.clip(g + rng.integers(-6, 7, (h, w, 3)), 0, 255).astype(np.uint8)
    if kind == 3:
        pal = rng.integers(0, 256, (int(rng.integers(2, 400)), 3)).astype(np.uint8)
        return pal[rng.integers(0, len(pal), (h, w))]
    if kind == 4:
        return (rng.integers(0, 4, (h, w, 3)) * int(rng.integers(1, 60))).astype(np.uint8)
    g = rng.integers(0, 256, (h, w)).astype(np.uint8)
    return np.stack([g, g, g], -1)


@pytest.mark.parametrize("seed", range(180))
def test_quantize_equals_pillow(seed):
    _same_as_pillow(_frame(seed))


def test_quantize_takes_a_tensor_on_its_device():
    """A CPU tensor gives the numpy frame's palette and indices."""
    f = _frame(7)
    got = quantize.quantize(torch.from_numpy(f))
    want = quantize.quantize(f)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


# -- the rules --------------------------------------------------------------------------------


def _red(counts: dict):
    """A one-row frame of reds (value: pixel count), green and blue 0."""
    vals = np.concatenate([np.full(n, v) for v, n in counts.items()])
    return np.stack([vals, np.zeros_like(vals), np.zeros_like(vals)], -1).astype(
        np.uint8).reshape(1, -1, 3)


def _among_fillers(cluster: np.ndarray, n: int):
    """``cluster`` (red <= 210, green <= 77, blue 0; under 64 pixels) set
    beside 256 - ``n`` filler colours of 64 pixels each, above it on every
    channel: a box of fillers outweighs the cluster and a cut of a box of
    both takes fillers alone off the top, so every filler is split off
    before the cluster is cut, and the cluster's cuts are those of it alone
    into ``n`` boxes. → (the frame, Pillow's and the port's palette and
    indices equal, the cluster's entries in palette order, the cluster's
    indices)."""
    i = np.arange(256 - n)
    fill = np.stack([220 + i % 36, 100 + i // 36 * 20, np.full(len(i), 200)], -1)
    flat = cluster.reshape(-1, 3)
    frame = np.concatenate([np.repeat(fill, 64, 0), flat]).astype(np.uint8).reshape(1, -1, 3)
    idx, pal = _same_as_pillow(frame)
    filler = {tuple(c) for c in fill.tolist()}
    mine = [c for c in pal.tolist() if tuple(c) not in filler]
    assert len(mine) == n and len(pal) == 256
    return mine, idx[0, -len(flat):], pal


def _scale(frame) -> tuple:
    """(the bits Quant.c's hash drops per channel, the port's) of a frame."""
    flat = frame.reshape(-1, 3).astype(np.int64)
    want = next(s for s in range(8) if len(np.unique(flat >> s, axis=0)) <= 65536)
    keys, counts = torch.unique(torch.from_numpy((flat[:, 0] << 16) | (flat[:, 1] << 8)
                                                 | flat[:, 2]), return_counts=True)
    return want, quantize.coarse_histogram(keys, counts)[0]


def test_rule_the_hash_coarsens_above_65536_colours():
    """65,536 distinct colours are cut as they are; one more and every
    channel drops its low bit (Quant.c rebuilds its hash), and a frame of
    random colours drops as many bits as it takes to get under 65,536."""
    packed = np.arange(65536) * 97 % (1 << 24)
    base = np.stack([packed >> 16, (packed >> 8) & 255, packed & 255], -1).astype(np.uint8)
    assert _scale(base) == (0, 0)
    _same_as_pillow(base.reshape(256, 256, 3))
    more = np.concatenate([base, [[255, 254, 253], [255, 254, 253]]]).astype(np.uint8)
    assert len(np.unique(more, axis=0)) == 65537
    want, got = _scale(more)
    assert got == want >= 1
    _same_as_pillow(more.reshape(2, 65538 // 2, 3))
    noise = np.random.default_rng(5).integers(0, 256, (300, 300, 3)).astype(np.uint8)
    assert _scale(noise) == (3, 3)
    _same_as_pillow(noise)


def test_rule_the_box_of_most_pixels_is_split_next():
    """Of {210, 200} (40 pixels, range 10) and {100, 0} (2 pixels, range
    100), the heap splits the one of more pixels, not the larger."""
    mine, _, _ = _among_fillers(_red({210: 20, 200: 20, 100: 1, 0: 1}), 3)
    assert [c[0] for c in mine] == [210, 200, 50]


def test_rule_the_widest_weighted_axis_is_cut_red_first_on_a_tie():
    """Ranges weigh 77:150:29: a green range of 60 outweighs a red one of
    100 (9000 against 7700); where the weighted ranges are equal (red 150,
    green 77) red is cut."""
    sq = [(0, 0, 0), (100, 0, 0), (0, 60, 0), (100, 60, 0)]
    frame = np.array(sq * 3, np.uint8).reshape(3, 4, 3)
    assert _among_fillers(frame, 2)[0] == [[50, 60, 0], [50, 0, 0]]
    tie = np.array([(0, 0, 0), (150, 0, 0), (0, 77, 0), (150, 77, 0)] * 3, np.uint8).reshape(3, 4, 3)
    assert _among_fillers(tie, 2)[0] == [[150, 39, 0], [0, 39, 0]]


def test_rule_the_median_run_stays_whole_and_the_lowest_run_alone_is_cut_off():
    """Counted from the high end, half of {100: 1, 50: 5, 0: 1} is passed in
    the run of 50, which goes whole with 100; where half is passed only in
    the lowest run, that run alone makes the second box."""
    assert [c[0] for c in _among_fillers(_red({100: 1, 50: 5, 0: 1}), 2)[0]] == [58, 0]
    assert [c[0] for c in _among_fillers(_red({200: 1, 0: 10}), 2)[0]] == [200, 0]


def test_rule_each_entry_is_its_boxs_mean_rounded_half_up():
    """{2, 3} one pixel each: the mean 2.5 is entry 3 (half up, not to
    even); and the mean is of the full-precision pixels where the hash is
    coarse (covered by the 65,537-colour frame above)."""
    assert [c[0] for c in _among_fillers(_red({200: 3, 3: 1, 2: 1}), 2)[0]] == [200, 3]
    assert [c[0] for c in _among_fillers(_red({200: 3, 1: 1, 0: 1}), 2)[0]] == [200, 1]


def test_rule_a_tie_keeps_the_boxs_own_entry():
    """Red 15 lies in the box {15, 0, 0} of entry 5, as far from it as from
    entry 0 (25): it keeps its own entry 1, not the lowest index."""
    mine, idx, pal = _among_fillers(_red({30: 2, 20: 2, 15: 1, 0: 2}), 2)
    assert [c[0] for c in mine] == [25, 5]
    assert pal[idx[4]].tolist() == [5, 0, 0]


def test_rule_the_mapping_searches_from_the_boxs_entry():
    """A colour strictly nearer two other entries than its box's takes,
    of those, the one nearest its box's entry (then the lowest index),
    the order Quant.c sorts its distance table in; a transcription of
    Quant.c's loop agrees on random palettes."""
    pal = np.array([[0, 0, 0], [14, 0, 0], [6, 0, 0]], np.uint8)
    # red 10 in the box of entry 0: entries 1 and 2 both at 16, entry 2 nearer entry 0
    assert int(quantize.nearest(torch.tensor([[10, 0, 0]]), torch.tensor([0]), pal)[0]) == 2
    assert int(quantize.nearest(torch.tensor([[7, 0, 0]]), torch.tensor([1]), pal)[0]) == 2
    rng = np.random.default_rng(3)
    for _ in range(20):
        pal = rng.integers(0, 8, (12, 3)).astype(np.uint8) * 16
        cols = rng.integers(0, 8, (200, 3)) * 16 + rng.integers(-8, 9, (200, 3))
        cols = np.clip(cols, 0, 255)
        box = rng.integers(0, 12, 200)
        got = quantize.nearest(torch.from_numpy(cols), torch.from_numpy(box), pal).numpy()
        p = pal.astype(np.int64)
        dist = ((p[:, None] - p[None]) ** 2).sum(2)
        for c, b, g in zip(cols, box, got):
            order = sorted(range(12), key=lambda j: (dist[b, j], j))
            best, bestd = b, ((p[b] - c) ** 2).sum()
            for j in order:
                if dist[b, j] > 4 * ((p[b] - c) ** 2).sum():
                    break
                d = ((p[j] - c) ** 2).sum()
                if d < bestd:
                    best, bestd = j, d
            assert g == best


def test_rule_256_colours_or_fewer_go_through_the_cut():
    """A frame of five colours keeps them, in the cut's order (high half
    first), not in sorted order."""
    cols = np.array([[10, 200, 30], [250, 0, 0], [0, 0, 255], [128, 128, 128], [5, 5, 5]],
                    np.uint8)
    frame = cols[np.random.default_rng(2).integers(0, 5, (9, 11))]
    idx, pal = _same_as_pillow(frame)
    assert np.array_equal(pal[idx], frame) and len(pal) == 5
    assert pal.tolist() != np.unique(cols, axis=0).tolist()


# -- the committed hashes and the GIF writer ---------------------------------------------------


@pytest.mark.parametrize("name", sorted(json.loads(REFS.read_text())))
def test_quant_refs_are_pillows_and_the_ports(name):
    ref = json.loads(REFS.read_text())[name]
    frame = S.quant_frames()[name]
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731
    idx, pal = quantize.quantize(frame)
    assert (len(pal), sha(pal), sha(idx)) == (ref["entries"], ref["palette_sha256"],
                                             ref["index_sha256"])
    want_idx, want_pal = _pillow(frame)
    assert (sha(want_pal), sha(want_idx)) == (ref["palette_sha256"], ref["index_sha256"])


@pytest.mark.parametrize("seed", range(6))
def test_a_gif_the_port_writes_reads_back_as_the_references(seed, jax_cpu):
    """One frame through ``imencode(".gif")``: Pillow reads the port's file
    and the reference's to the same pixels."""
    f = _frame(seed * 6 + 2) if seed % 2 else _frame(seed * 6)
    bgr = np.ascontiguousarray(f[..., ::-1])
    mine = imgcodecs.imencode(".gif", Mat.from_array(bgr, device="cpu"))
    ref = jax_codecs.imencode(".gif", JMat.from_array(bgr))
    got = np.asarray(Image.open(io.BytesIO(mine)).convert("RGB"))
    want = np.asarray(Image.open(io.BytesIO(ref)).convert("RGB"))
    assert np.array_equal(got, want)
