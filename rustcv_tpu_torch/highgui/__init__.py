"""highgui — window display + key events (headless-capable; port of
``rustcv_tpu.highgui``).

Reference: ``rustcv/src/highgui/mod.rs:12-141`` — a global window manager
(name → window), ``imshow`` recreating the window on size change,
``wait_key`` mapping Esc/Space/Enter/Q → 27/32/13/113, BGR→0x00RRGGBB
packing for the framebuffer.

Accelerator hosts are usually headless, so the "window" is a sink
abstraction:
- default: an in-memory framebuffer (inspectable via :func:`get_window_frame`
  — what a test or notebook polls instead of a screen); ``imshow`` of a Mat
  on the card downloads it;
- ``RUSTCV_TPU_DISPLAY_DIR=/path``: each imshow also writes
  ``{name}.png`` there (the port's PNG writer, :mod:`..imgcodecs.host`),
  through a temporary file and ``os.replace``, so a reader never sees half
  a file;
- key events come from :func:`push_key` (tests/automation) — ``wait_key``
  sleeps the requested delay and pops the injected queue, returning -1 when
  empty, exactly like the reference with no key down;
- **real window (opt-in)**: when ``DISPLAY`` is set (or ``RUSTCV_GUI=1``),
  imshow additionally drives an SDL window (pygame) — recreated on size
  change like the reference's minifb path (mod.rs:36-70) — and ``wait_key``
  polls the real keyboard with the same Esc/Space/Enter/Q map.
  ``RUSTCV_GUI=dummy`` uses SDL's off-screen driver (headless CI for the
  real code path); ``RUSTCV_GUI=0`` forces the sink even under X.
  One OS window at a time (SDL display model); named sinks are unlimited.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from ..core.mat import Mat

# Key mapping (highgui/mod.rs:85-112)
KEY_ESC = 27
KEY_SPACE = 32
KEY_ENTER = 13
KEY_Q = 113

_lock = threading.Lock()
_windows: Dict[str, np.ndarray] = {}
_key_queue: Deque[int] = deque()
_gui = None  # lazy _SdlWindow singleton (False once probing failed)


def _gui_wanted() -> bool:
    v = os.environ.get("RUSTCV_GUI", "")
    if v in ("0", "off"):
        return False
    if v in ("1", "dummy"):
        return True
    return bool(os.environ.get("DISPLAY"))


class _SdlWindow:
    """The opt-in real window: SDL (pygame) surface + keyboard events."""

    def __init__(self):
        if os.environ.get("RUSTCV_GUI") == "dummy":
            os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
        import pygame

        pygame.display.init()
        self.pg = pygame
        self.size: Optional[Tuple[int, int]] = None
        self.name: Optional[str] = None
        self.screen = None

    def show(self, name: str, frame_bgr: np.ndarray) -> None:
        pg = self.pg
        h, w = frame_bgr.shape[:2]
        if self.size != (w, h) or self.name != name:
            # Recreate on size change — the reference drops and rebuilds the
            # minifb window (mod.rs:36-70); SDL set_mode does the same.
            self.screen = pg.display.set_mode((w, h))
            pg.display.set_caption(name)
            self.size = (w, h)
            self.name = name
        rgb = np.ascontiguousarray(frame_bgr[..., ::-1])
        surf = pg.image.frombuffer(rgb.tobytes(), (w, h), "RGB")
        self.screen.blit(surf, (0, 0))
        pg.display.flip()

    def poll_key(self) -> int:
        pg = self.pg
        keymap = {
            pg.K_ESCAPE: KEY_ESC, pg.K_SPACE: KEY_SPACE,
            pg.K_RETURN: KEY_ENTER, pg.K_q: KEY_Q,
        }
        for e in pg.event.get():
            if e.type == pg.KEYDOWN and e.key in keymap:
                return keymap[e.key]
            if e.type == pg.QUIT:
                return KEY_ESC
        return -1

    def close(self) -> None:
        self.pg.display.quit()
        self.size = None
        self.name = None


def _get_gui():
    """The live window backend, or None (headless / probing failed)."""
    global _gui
    if _gui is None:
        if not _gui_wanted():
            return None
        try:
            _gui = _SdlWindow()
        except Exception:  # noqa: BLE001 — no SDL/X: degrade to the sink
            _gui = False
    return _gui or None


def mat_to_u32_buffer(mat: Mat) -> np.ndarray:
    """BGR bytes → 0x00RRGGBB u32 framebuffer (mod.rs:125-141)."""
    a = mat.to_numpy().astype(np.uint32)
    b, g, r = a[..., 0], a[..., 1], a[..., 2]
    return (r << 16) | (g << 8) | b


def imshow(winname: str, mat: Mat) -> None:
    """Present a frame. Size changes just replace the buffer (the reference
    recreates the OS window, mod.rs:36-70 — here the sink is elastic)."""
    frame = mat.to_numpy()
    with _lock:
        _windows[winname] = frame
        gui = _get_gui()
        if gui is not None:
            gui.show(winname, frame)
    out_dir = os.environ.get("RUSTCV_TPU_DISPLAY_DIR")
    if out_dir:
        from ..imgcodecs import host as _codecs

        os.makedirs(out_dir, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in winname)
        tmp = os.path.join(out_dir, f".{safe}.tmp.png")
        with open(tmp, "wb") as f:
            f.write(_codecs.write_png(_codecs.from_mat_array(frame)))
        os.replace(tmp, os.path.join(out_dir, f"{safe}.png"))


def get_window_frame(winname: str) -> Optional[np.ndarray]:
    with _lock:
        f = _windows.get(winname)
        return None if f is None else f.copy()


def window_names() -> Tuple[str, ...]:
    with _lock:
        return tuple(_windows.keys())


def push_key(key: int) -> None:
    """Inject a key event (the headless stand-in for a real keyboard)."""
    with _lock:
        _key_queue.append(key)


def wait_key(delay_ms: int = 0) -> int:
    """Wait ``delay_ms`` then return the next key, or -1.

    Injected keys (:func:`push_key`) take precedence; with the opt-in real
    window active, the keyboard is polled for the whole delay (reference
    semantics: sleep then check key state, mod.rs:85-112)."""
    with _lock:
        gui = _get_gui()
    deadline = time.monotonic() + delay_ms / 1000.0
    while True:
        with _lock:
            if _key_queue:
                return _key_queue.popleft()
        if gui is not None:
            k = gui.poll_key()
            if k != -1:
                return k
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return -1
        time.sleep(min(0.005, remaining))


def destroy_window(winname: str) -> None:
    global _gui
    with _lock:
        _windows.pop(winname, None)
        if _gui and _gui.name == winname:
            _gui.close()
            _gui = None  # stale handle would crash the next poll/show


def destroy_all_windows() -> None:
    global _gui
    with _lock:
        _windows.clear()
        if _gui:
            _gui.close()
            _gui = None


__all__ = [
    "KEY_ENTER", "KEY_ESC", "KEY_Q", "KEY_SPACE", "destroy_all_windows",
    "destroy_window", "get_window_frame", "imshow", "mat_to_u32_buffer",
    "push_key", "wait_key", "window_names",
]
