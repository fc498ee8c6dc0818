"""On-card probes of the port: :mod:`.mosaic_shuffle`, the counterpart of
``probe_mosaic_shuffle.py`` (``python -m rustcv_tpu_torch.probes.mosaic_shuffle``);
:mod:`.kernel_ab`, this checkout's kernels timed beside another checkout's;
:mod:`.template_rounding`, template matching's distance from exact
arithmetic on the 1080p test pattern."""
