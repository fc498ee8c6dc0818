"""How far ``ops.template.match_template`` sits from exact arithmetic on
the 1080p test pattern that ``chip_smoke.py`` phase 3p matches (every
fifth row noise, its 24×24 and 64×64 cuts), beside the same FFT
correlation of the uncentred image.

    python -m rustcv_tpu_torch.probes.template_rounding [cpu|cuda]

The reference map is the same formula in float64 (``torch.fft`` in float64,
exact window sums). For each template and method it prints the largest
|map − reference| / max(1, max |reference|), the measure of the 1e-4 bar
of ``tests/test_template.py``; for ``ccoeff_normed`` also the uncentred
correlation's, repeated on fresh copies of the image (an FFT library may
take another code path for another buffer). The last line is a JSON object
of these numbers.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..capture.simulation import synth_bgr
from ..ops import template
from ..ops.color import bgr_to_gray

CUTS = {24: (500, 900), 64: (300, 1200)}  # side → (y, x), as phase 3p cuts them


def _pattern() -> np.ndarray:
    img = synth_bgr(1920, 1080, 11)
    img[::5] = np.random.default_rng(12).integers(0, 256, img[::5].shape, np.uint8)
    return bgr_to_gray(torch.from_numpy(img)).numpy()


def _exact(img: np.ndarray, tmpl: np.ndarray, method: str) -> np.ndarray:
    """The map in float64: FFT correlation and exact window sums."""
    a = torch.from_numpy(img.astype(np.float64))
    t = torch.from_numpy(tmpl.astype(np.float64))
    th, tw = t.shape
    h, w = a.shape
    s1, s2 = (x.to(torch.float64) for x in template._window_sums(torch.from_numpy(img), th, tw))

    def cross(k):
        spec = torch.fft.rfft2(a) * torch.conj(torch.fft.rfft2(k, s=(h, w)))
        return torch.fft.irfft2(spec, s=(h, w))[: h - th + 1, : w - tw + 1]

    if method == "sqdiff":
        return (s2 - 2.0 * cross(t) + torch.sum(t * t)).numpy()
    if method == "ccorr_normed":
        return (cross(t) / torch.sqrt(s2 * torch.sum(t * t))).numpy()
    tp = t - t.mean()
    var = torch.clamp(s2 - s1 * s1 / (th * tw), min=0.0) * torch.sum(tp * tp)
    den = torch.sqrt(var)
    return torch.where(den > 1e-6, cross(tp) / torch.clamp(den, min=1e-20), 0.0).numpy()


def _uncentred_ccoeff(img: torch.Tensor, tmpl: torch.Tensor) -> np.ndarray:
    """``ccoeff_normed`` with the FFT correlation of the image as it is."""
    th, tw = tmpl.shape
    s1, s2 = template._window_sums(img, th, tw)
    t = tmpl.to(torch.float32)
    tp = t - torch.mean(t)
    den = torch.sqrt(torch.clamp(s2 - s1 * s1 / float(th * tw), min=0.0) * torch.sum(tp * tp))
    c = template._fft_cross(img.to(torch.float32), tp)
    return torch.where(den > 1e-6, c / torch.clamp(den, min=1e-20), 0.0).cpu().numpy()


def main(device: str) -> dict:
    gray = _pattern()
    img = torch.from_numpy(gray).to(device)
    out = {}
    for n, (y, x) in CUTS.items():
        cut = gray[y:y + n, x:x + n]
        tmpl = torch.from_numpy(cut).to(device)
        for method in template.METHODS:
            want = _exact(gray, cut, method)
            scale = max(1.0, float(np.abs(want).max()))
            got = template.match_template(img, tmpl, method).cpu().numpy()
            out[f"{n} {method}"] = float(np.abs(got - want).max()) / scale
            if method == "ccoeff_normed":
                out[f"{n} {method} uncentred"] = [
                    float(np.abs(_uncentred_ccoeff(img.clone(), tmpl) - want).max()) / scale
                    for _ in range(3)]
            print(f"{n}x{n} {method}: {out[f'{n} {method}']:.3g}"
                  + (f", uncentred {out[f'{n} {method} uncentred']}"
                     if method == "ccoeff_normed" else ""), flush=True)
    return out


if __name__ == "__main__":
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if dev == "cuda" and not torch.cuda.is_available():
        sys.exit("template_rounding: no CUDA card (pass 'cpu' to run on the host)")
    print(json.dumps({"device": dev, "max_abs_err_over_scale": main(dev)}))
