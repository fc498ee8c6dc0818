"""Format negotiation — priority-scored mode selection.

Ports the three negotiation strategies in the reference:

1. :func:`score_mode` — V4L2 scoring (``rustcv-backend-v4l2/src/device.rs:125-146``):
   exact-resolution matches add ``priority*10`` per satisfied requirement,
   format matches add ``priority*10``, plus a ``width/100`` big-is-better
   tiebreak.
2. :func:`score_mode_msmf` — MSMF single-pass scoring
   (``rustcv-backend-msmf/src/device.rs:395-443``): first exact resolution
   requirement wins ``priority*10``; otherwise a ``-min L1 distance`` penalty,
   or ``-1000`` when requirements exist but nothing is close; format match
   adds ``priority*10``.
3. :func:`negotiate_simple` — Stack-B policy
   (``rustcv-camera/src/backend/linux/mod.rs:285-390``): explicit format →
   min-distance resolution within that format; otherwise joint minimization
   of L1 resolution distance + format-preference penalty (fps≥60: raw 0 /
   MJPEG 100 / other 200; fps<60: MJPEG 0 / raw 50 / other 200).

All are pure functions over :class:`ModeDescriptor` lists — the same scoring
drives the simulation driver and any future real backend.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

from ..core.config import CameraConfig, Priority, ResolvedConfig, SimpleConfig
from ..core.errors import FormatNotSupported, ResolutionNotSupported
from ..core.pixel_format import PixelFormat

from .source import ModeDescriptor


def score_mode(config: CameraConfig, w: int, h: int, fmt: PixelFormat) -> int:
    """V4L2-style additive score (device.rs:125-146)."""
    score = 0
    for req_w, req_h, prio in config.resolution_req:
        if w == req_w and h == req_h:
            score += int(prio) * 10
    for req_fmt, prio in config.format_req:
        if fmt == req_fmt:
            score += int(prio) * 10
    score += w // 100  # bigger-resolution tiebreak
    return score


def score_mode_msmf(config: CameraConfig, w: int, h: int, fmt: PixelFormat) -> int:
    """MSMF-style single-pass score with distance penalty (device.rs:395-443)."""
    resolution_score = 0
    min_distance: Optional[int] = None
    for req_w, req_h, prio in config.resolution_req:
        if w == req_w and h == req_h:
            resolution_score = int(prio) * 10
            min_distance = 0
            break
        d = abs(w - req_w) + abs(h - req_h)
        min_distance = d if min_distance is None else min(min_distance, d)

    format_score = 0
    for req_fmt, prio in config.format_req:
        if fmt == req_fmt:
            format_score = int(prio) * 10
            break

    if resolution_score > 0:
        distance_term = 0
    elif min_distance is not None:
        distance_term = -min_distance
    elif config.resolution_req:
        distance_term = -1000
    else:
        distance_term = 0
    return resolution_score + format_score + distance_term


def negotiate(
    config: CameraConfig, modes: Iterable[ModeDescriptor]
) -> ModeDescriptor:
    """Pick the best mode by :func:`score_mode`; enforce REQUIRED constraints.

    A ``Priority.REQUIRED`` resolution or format requirement that the chosen
    mode does not satisfy raises (the reference's ``Required`` contract,
    ``builder.rs:17``).
    """
    modes = list(modes)
    if not modes:
        raise FormatNotSupported("<no modes>")
    best = max(modes, key=lambda m: score_mode(config, m.width, m.height, m.pixel_format))

    for req_w, req_h, prio in config.resolution_req:
        if prio == Priority.REQUIRED and (best.width, best.height) != (req_w, req_h):
            if any((m.width, m.height) == (req_w, req_h) for m in modes):
                # A required resolution exists but scored lower (e.g. another
                # required entry won) — prefer satisfying it.
                candidates = [m for m in modes if (m.width, m.height) == (req_w, req_h)]
                best = max(
                    candidates,
                    key=lambda m: score_mode(config, m.width, m.height, m.pixel_format),
                )
            else:
                raise ResolutionNotSupported(req_w, req_h)
    for req_fmt, prio in config.format_req:
        if prio == Priority.REQUIRED and best.pixel_format != req_fmt:
            candidates = [m for m in modes if m.pixel_format == req_fmt]
            if not candidates:
                raise FormatNotSupported(req_fmt)
            best = max(
                candidates,
                key=lambda m: score_mode(config, m.width, m.height, m.pixel_format),
            )
    return best


def negotiate_simple(
    config: SimpleConfig, modes: Iterable[ModeDescriptor]
) -> Tuple[ModeDescriptor, int]:
    """Stack-B negotiation (linux/mod.rs:285-390) → (mode, fps)."""
    modes = list(modes)
    if not modes:
        raise FormatNotSupported("<no modes>")
    target_w = config.width if config.width is not None else 640
    target_h = config.height if config.height is not None else 480
    target_fps = config.fps if config.fps is not None else 30

    def distance(m: ModeDescriptor) -> int:
        return abs(m.width - target_w) + abs(m.height - target_h)

    if config.pixel_format is not None:
        candidates = [m for m in modes if m.pixel_format == config.pixel_format]
        if not candidates:
            raise FormatNotSupported(config.pixel_format)
        best = min(candidates, key=distance)
    else:
        def penalty(fmt: PixelFormat) -> int:
            raw = (PixelFormat.YUYV, PixelFormat.NV12)
            if target_fps >= 60:
                return 0 if fmt in raw else (100 if fmt == PixelFormat.MJPEG else 200)
            return 0 if fmt == PixelFormat.MJPEG else (50 if fmt in raw else 200)

        best = min(modes, key=lambda m: distance(m) + penalty(m.pixel_format))

    fps = min(best.fps_options, key=lambda f: abs(f - target_fps))
    return best, fps


def resolve(config: SimpleConfig, modes: Iterable[ModeDescriptor]) -> ResolvedConfig:
    mode, fps = negotiate_simple(config, modes)
    return ResolvedConfig(
        width=mode.width,
        height=mode.height,
        fps=fps,
        pixel_format=mode.pixel_format,
        buffer_count=config.buffer_count,
    )
