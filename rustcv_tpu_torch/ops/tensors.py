"""Tensor helpers of the feature and flow ops.

:func:`full_f32`: cuBLAS and cuDNN may run float32 matmuls and
convolutions in TF32 (10-bit mantissas) when
``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32`` is set; cuDNN's flag is on by default.
The ops whose reference asks for full float32 products (the DCT basis
products, template matching's correlation, HOG's window scores, ECC's
normal equations, the Hamming products of binary descriptors) run inside
it: both flags off for the call, restored after. On the CPU it does
nothing.

:func:`as_tensor`: the functions the reference exposes as jitted device
functions take tensors and stay on their device; a numpy input goes to the
card, as the reference sends it to its default device.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch


@contextmanager
def full_f32(device):
    if torch.device(device).type != "cuda":
        yield
        return
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` itself if it is a tensor (moved to ``device`` when one is
    given), else a tensor of its values on ``device`` or the card."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device if device is not None else "cuda")
