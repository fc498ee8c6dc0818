"""Write ``tests/data/gif/quant_refs.json``: Pillow's median cut of the
GIF quantizer's frames (``chip_smoke.quant_frames``), which phase 3z holds
the port's :mod:`rustcv_tpu_torch.imgcodecs.quantize` to on the card's
machine, where there is no Pillow, and ``tests/test_torch_quantize.py``
on the CPU.

Run it where Pillow 12.1 is present:

    python tools/make_quant_refs.py [--out FILE]

Each frame goes through ``Image.fromarray(frame).convert("P",
palette=Image.Palette.ADAPTIVE)``, what Pillow's GIF writer does to an RGB
frame; the JSON holds per frame its shape, its number of distinct colours,
the number of palette entries (``getpalette()``) and the SHA-256 of the
palette's bytes ((m, 3) u8) and of the index map's ((H, W) u8). The port
never runs this script; a second run rewrites the file byte for byte.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "gif", "quant_refs.json")


def pillow_quantize(frame: np.ndarray):
    """Pillow's (index map (H, W) u8, palette (m, 3) u8) of an RGB frame."""
    from PIL import Image

    im = Image.fromarray(frame).convert("P", palette=Image.Palette.ADAPTIVE)
    return np.asarray(im), np.array(im.getpalette(), np.uint8).reshape(-1, 3)


def references() -> dict:
    out = {}
    for name, frame in sorted(chip_smoke.quant_frames().items()):
        idx, pal = pillow_quantize(frame)
        out[name] = {
            "shape": list(frame.shape),
            "colours": int(len(np.unique(frame.reshape(-1, 3), axis=0))),
            "entries": int(len(pal)),
            "palette_sha256": hashlib.sha256(pal.tobytes()).hexdigest(),
            "index_sha256": hashlib.sha256(np.ascontiguousarray(idx).tobytes()).hexdigest(),
        }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    refs = references()
    with open(args.out, "w") as f:
        json.dump(refs, f, indent=1, sort_keys=True)
        f.write("\n")
    for name, r in refs.items():
        print(f"{name}: {r['colours']} colours, {r['entries']} entries", flush=True)


if __name__ == "__main__":
    main()
