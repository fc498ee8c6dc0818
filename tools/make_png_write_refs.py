"""Write ``tests/data/png/write_refs.json``: what Pillow writes of each case
of ``chip_smoke.png_write_frames()``, which phase 3za of ``chip_smoke.py``
holds the port's PNG writes to on the card (its machine has no Pillow).

Run it where Pillow 12.1 is present:

    python tools/make_png_write_refs.py [--out FILE]

A still case is ``Image.fromarray(frame).save(buf, "PNG")``, an animation
``save(buf, "PNG", save_all=True, append_images=..., **arguments)``, as the
reference's ``imencode``, ``imwritemulti`` and ``imwriteanimation`` save
them. Per case the file holds ``chip_smoke.png_summary`` of Pillow's
bytes: the size, the chunk kinds in order, IHDR, acTL, every fcTL and fdAT
with their sequence numbers, and the SHA-256 of each frame's image data
before zlib. A second run rewrites the file byte for byte.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "png", "write_refs.json")


def pillow_png(frames, kw) -> bytes:
    """Pillow's file of a case: a still PNG (``kw`` None) or an animation."""
    from PIL import Image

    ims = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    if kw is None:
        ims[0].save(buf, "PNG")
    else:
        ims[0].save(buf, "PNG", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    refs = {}
    for name, (frames, kw) in sorted(chip_smoke.png_write_frames().items()):
        refs[name] = chip_smoke.png_summary(pillow_png(frames, kw))
        print(f"{name}: {refs[name]['bytes']} bytes, {len(refs[name]['frames_sha256'])} "
              f"frame(s)", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(refs, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
