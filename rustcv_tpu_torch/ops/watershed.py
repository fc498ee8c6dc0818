"""Marker-based watershed segmentation (port of ``rustcv_tpu.ops.watershed``;
the OpenCV ``watershed`` role).

Watershed-by-bottleneck in TWO schedule-independent phases (no priority
queue, no pointer chasing), on the image's device:

1. **Costs** — every pixel's minimum-bottleneck cost to any seed (cost
   of a path = max intensity en route; c(seed) = I(seed)). The (min,
   max) bottleneck semiring is associative, so directional inclusive
   scans iterated to a fixed point converge to the unique fixpoint.
2. **Labels** — the smallest seed label that reaches each pixel along a
   bottleneck-OPTIMAL path: min-label propagation over the fixed edge
   set {q→p : max(c*(q), I(p)) = c*(p)}, by gated min-scans (the gate
   breaks the segment), again to a fixed point. Pure min over a fixed
   graph — unique fixpoint, so the result is deterministic.

PyTorch has no associative scan with a custom combine, so each
directional scan is a Hillis–Steele doubling scan: ⌈log₂ n⌉ rounds, each
combining every element with the one 2^r before it (shifted views, the
reference's combine), never a loop over columns. A fixed point is a
Python loop of rounds with one flag read per round; no fixed point in
``max_rounds`` raises.

Frozen spec:
- cost(p) = min over 4-connected paths from any seed of max(intensity
  along path, including both endpoints);
- label(p) = min label over seeds with a bottleneck-optimal path to p;
  seed pixels always keep their own marker value and are never ridge;
- output (OpenCV markers convention): -1 on watershed lines (a pixel
  whose LEFT or UP 4-neighbor carries a different positive label), else
  the region label; 0 only when there are no seeds at all;
- markers: int32 (H, W), 0 = unknown, positive labels = seeds.

Oracle: the same two fixpoints by plain Jacobi relaxation (both unique,
so the schedule difference cannot matter) — the tensor twin matches it
exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .tensors import as_tensor

_INF = 2**30
MAX_LABEL = 2**30 - 1


def _doubling_scan(elems, comb, dim: int, reverse: bool):
    """Inclusive scan of a tuple of tensors along ``dim`` under the
    associative ``comb(earlier, later)`` (Hillis–Steele); ``reverse``
    scans from the far end."""
    if reverse:
        elems = tuple(torch.flip(e, [dim]) for e in elems)
    n = elems[0].shape[dim]
    d = 1
    while d < n:
        head = tuple(e.narrow(dim, 0, d) for e in elems)
        earlier = tuple(e.narrow(dim, 0, n - d) for e in elems)
        later = tuple(e.narrow(dim, d, n - d) for e in elems)
        elems = tuple(torch.cat([h, c], dim) for h, c in zip(head, comb(earlier, later)))
        d *= 2
    if reverse:
        elems = tuple(torch.flip(e, [dim]) for e in elems)
    return elems


def _cost_comb(a, b):
    c1, m1 = a
    c2, m2 = b
    return torch.minimum(c2, torch.maximum(c1, m2)), torch.maximum(m1, m2)


def _gate_comb(a, b):
    m1, b1 = a
    m2, b2 = b
    return torch.minimum(m2, torch.where(b2 > 0, m1, _INF)), b1 * b2


def _fix(round_fn, init, max_rounds: int):
    """Apply ``round_fn`` until nothing changes (one flag read per round)
    → (fixed point, converged)."""
    cur, changed = init, True
    for _ in range(max_rounds):
        nxt = round_fn(cur)
        changed = bool((nxt != cur).any())
        cur = nxt
        if not changed:
            break
    return cur, not changed


def _shift(a: torch.Tensor, dim: int, rev: bool) -> torch.Tensor:
    """Each element's predecessor along ``dim`` (the next one when
    ``rev``), _INF past the edge."""
    n = a.shape[dim]
    pad = torch.full_like(a.narrow(dim, 0, 1), _INF)
    if rev:
        return torch.cat([a.narrow(dim, 1, n - 1), pad], dim)
    return torch.cat([pad, a.narrow(dim, 0, n - 1)], dim)


def _flood(gray: torch.Tensor, markers: torch.Tensor, max_rounds: int = 512):
    """The two fixed points on the image's device → (int32 segmentation,
    converged)."""
    inten = gray.to(torch.int32)
    seeded = markers > 0
    dirs = ((-1, False), (-1, True), (-2, False), (-2, True))

    def cost_round(c):
        for dim, rev in dirs:
            c = _doubling_scan((c, inten), _cost_comb, dim, rev)[0]
        return c

    cost, ok1 = _fix(cost_round, torch.where(seeded, inten, _INF), max_rounds)

    # gate(x) := edge (x−1)→x valid := max(c*(x−1), I(x)) == c*(x)
    gates = {(dim, rev): (torch.maximum(_shift(cost, dim, rev), inten) == cost).to(torch.int32)
             for dim, rev in dirs}

    def label_round(lab):
        for dim, rev in dirs:
            lab = _doubling_scan((lab, gates[(dim, rev)]), _gate_comb, dim, rev)[0]
        return lab

    labels, ok2 = _fix(label_round, torch.where(seeded, markers.to(torch.int32), _INF),
                       max_rounds)
    labels = torch.where(labels < _INF, labels, 0)
    labels = torch.where(seeded, markers.to(torch.int32), labels)  # seeds keep their value
    # watershed lines: left/up neighbor carries a DIFFERENT positive label
    left = torch.nn.functional.pad(labels, (1, 0))[:, :-1]
    up = torch.nn.functional.pad(labels, (0, 0, 1, 0))[:-1, :]
    pos = labels > 0
    ridge = ((left > 0) & pos & (left != labels)) | ((up > 0) & pos & (up != labels))
    return torch.where(ridge & ~seeded, -1, labels).to(torch.int32), ok1 and ok2


def watershed(gray, markers, max_rounds: int = 512):
    """u8 gray (H, W) × int32 markers (H, W) → int32 segmentation (−1
    ridge, labels elsewhere), on the gray image's device (numpy goes to
    the card); a tensor gray gives a tensor, numpy gives numpy. Raises on
    non-convergence."""
    g = as_tensor(gray)
    m = as_tensor(markers, g.device)
    if m.numel():
        lo, hi = (int(v) for v in torch.stack([m.min(), m.max()]).to(torch.int64).cpu())
        if lo < 0 or hi > MAX_LABEL:
            raise ValueError(f"marker labels must be in [0, {MAX_LABEL}]")
    out, converged = _flood(g, m, max_rounds)
    if not converged:
        raise ValueError(f"watershed: no fixed point in {max_rounds} rounds")
    return out if isinstance(gray, torch.Tensor) else out.cpu().numpy()


def watershed_numpy(gray: np.ndarray, markers: np.ndarray) -> np.ndarray:
    """Oracle — both fixpoints by Jacobi relaxation (unique, so any fair
    schedule gives the same answer as the device's scan sweeps)."""
    INF = np.int64(2**40)
    inten = gray.astype(np.int64)
    m = markers.astype(np.int64)
    h, w = gray.shape

    def neighbors(a, fill):
        out = []
        for shift in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            n = np.roll(a, shift, axis=(0, 1))
            if shift == (0, 1):
                n[:, 0] = fill
            elif shift == (0, -1):
                n[:, -1] = fill
            elif shift == (1, 0):
                n[0, :] = fill
            else:
                n[-1, :] = fill
            out.append(n)
        return out

    cost = np.where(m > 0, inten, INF)
    while True:
        prev = cost.copy()
        for n in neighbors(cost, INF):
            cost = np.minimum(cost, np.maximum(n, inten))
        if np.array_equal(cost, prev):
            break
    labels = np.where(m > 0, m, INF)
    while True:
        prev = labels.copy()
        for nc, nl in zip(neighbors(cost, INF), neighbors(labels, INF)):
            valid = np.maximum(nc, inten) == cost
            labels = np.minimum(labels, np.where(valid, nl, INF))
        if np.array_equal(labels, prev):
            break
    labels = np.where(labels < INF, labels, 0)
    labels = np.where(m > 0, m, labels)
    left = np.pad(labels, ((0, 0), (1, 0)))[:, :-1]
    up = np.pad(labels, ((1, 0), (0, 0)))[:-1, :]
    ridge = ((left > 0) & (labels > 0) & (left != labels)) | (
        (up > 0) & (labels > 0) & (up != labels))
    return np.where(ridge & (m <= 0), -1, labels).astype(np.int32)
