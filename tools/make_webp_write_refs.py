"""Write ``tests/data/webp/write_refs.json``: what the reference writes of
phase 3y's inputs (``chip_smoke.webp_write_inputs``), which the phase holds
the port's files to on the card's machine, where there is no Pillow.

Run it where Pillow 12.1 with its libwebp 1.6 is present:

    python tools/make_webp_write_refs.py [--out FILE]

Each input goes through Pillow as the reference's calls hand it over: a
still through ``Image.save(..., "WEBP")`` (``imgcodecs.imencode``), the
animation through ``save(..., save_all=True, append_images=...)``
(``imgcodecs.imwritemulti``: no durations, loop 0). The file is read back
with Pillow; the JSON holds per input its size in bytes, the mode, the
frame count, the durations, the loop and per frame the PSNR (dB, all
channels of the u8 RGB) of the RGB read back against the input's. The
port never runs this script; writing is deterministic.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "webp", "write_refs.json")
psnr, rgb_of = chip_smoke.webp_psnr, chip_smoke.webp_rgb


def reference_file(frames: list) -> bytes:
    """What the reference's Pillow writes of the frames (one: a still)."""
    from PIL import Image

    buf = io.BytesIO()
    images = [Image.fromarray(f) for f in frames]
    if len(images) == 1:
        images[0].save(buf, "WEBP")
    else:
        images[0].save(buf, "WEBP", save_all=True, append_images=images[1:])
    return buf.getvalue()


def references() -> dict:
    """{input name: the reference's size, mode, frame count, durations, loop
    and per-frame PSNR}."""
    from PIL import Image, ImageSequence

    out = {}
    for name, frames in sorted(chip_smoke.webp_write_inputs().items()):
        data = reference_file(frames)
        with Image.open(io.BytesIO(data)) as im:
            back = [(np.asarray(f.convert("RGB")), f.info.get("duration"))
                    for f in ImageSequence.Iterator(im)]
            out[name] = {"bytes": len(data), "mode": im.mode, "n_frames": im.n_frames,
                         "durations": [d for _, d in back], "loop": im.info.get("loop"),
                         "psnr": [psnr(b, rgb_of(f)) for (b, _), f in zip(back, frames)]}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    with open(args.out, "w") as f:
        json.dump(references(), f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
