"""Time the port's GIF writes in a given tree of the repo, so that two
commits can be compared on one card:

    python tools/gif_write_ab.py TREE LABEL

imports ``rustcv_tpu_torch`` from TREE and prints one ``GIFAB`` line: the
ms of ``imwritemulti`` of phase 4w's workload (8 test-pattern frames of
1920x1080, card Mats, to .gif) with the file's size, and of
``imencode(".gif")`` of one 1080p noise frame from a card Mat; each over
3 calls after a warm one, by CUDA events. Run it on the parent and the
change in turns (parent, change, change, parent) within one machine."""
import os
import sys
import tempfile

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rustcv_tpu_torch import imgcodecs  # noqa: E402
from rustcv_tpu_torch.capture.simulation import synth_bgr  # noqa: E402
from rustcv_tpu_torch.prelude import Mat  # noqa: E402


def ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


mats = [Mat.from_array(synth_bgr(1920, 1080, t), device="cuda") for t in range(8)]
for m in mats:
    m.device()
noise = Mat.from_device(torch.from_numpy(
    np.random.default_rng(254).integers(0, 256, (1080, 1920, 3)).astype(np.uint8)).cuda())
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "m.gif")
    t8 = ms(lambda: imgcodecs.imwritemulti(path, mats))
    size = os.path.getsize(path)
t1 = ms(lambda: imgcodecs.imencode(".gif", noise))
print(f"GIFAB tree={sys.argv[2]} imwritemulti_8x1080p_synth_ms={t8:.4f} bytes={size} "
      f"imencode_1080p_noise_ms={t1:.4f}", flush=True)
