"""Interactive terminal viewer (counterpart of pathtracer/viewer.py).

Frames render on the Renderer's device, are box-filtered to character
cells on the host and drawn as ANSI truecolor half-blocks (each glyph is
two vertical pixels: U+2580 with its own foreground and background).
Input is raw-mode stdin: WASD + QE move, arrows or IJKL look, +/- speed,
n denoise, t tone map, ESC/x quit, with the camera semantics of
integrator/camera.py, so a move resets accumulation. With a piped
stdin (no tty) the viewer only renders, until max_frames or ^C.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np


def downsample(img: np.ndarray, cols: int, rows_px: int) -> np.ndarray:
    """Box-average u8/f32 [H, W, 3] to at most (rows_px, cols) pixels.

    Integer box filter (exact mean over h x w boxes); the output height
    is even (half-block glyphs pack 2 pixels vertically).
    """
    h, w = img.shape[:2]
    out_w = max(2, min(cols, w))
    out_h = max(2, min(rows_px, h))
    out_h -= out_h % 2
    ys = (np.arange(out_h + 1) * h) // out_h
    xs = (np.arange(out_w + 1) * w) // out_w
    acc = np.add.accumulate(np.add.accumulate(
        img.astype(np.float64), axis=0), axis=1)
    acc = np.pad(acc, ((1, 0), (1, 0), (0, 0)))
    sums = (acc[ys[1:], :, :][:, xs[1:], :] - acc[ys[:-1], :, :][:, xs[1:], :]
            - acc[ys[1:], :, :][:, xs[:-1], :]
            + acc[ys[:-1], :, :][:, xs[:-1], :])
    areas = ((ys[1:] - ys[:-1])[:, None] * (xs[1:] - xs[:-1])[None, :])
    return sums / areas[..., None]


def frame_to_ansi(img: np.ndarray, cols: int = 80, rows: int = 24) -> str:
    """Render u8-range [H, W, 3] as ANSI truecolor half-block text of
    `rows` character rows (2 pixels each): the frame body only, no cursor
    control."""
    px = downsample(np.clip(img, 0, 255), cols, rows * 2)
    px = np.clip(px + 0.5, 0, 255).astype(np.uint8)
    lines = []
    for y in range(0, px.shape[0], 2):
        parts = []
        prev = None
        for t, b in zip(px[y], px[y + 1]):
            code = (int(t[0]), int(t[1]), int(t[2]),
                    int(b[0]), int(b[1]), int(b[2]))
            if code != prev:   # skip redundant SGR runs
                parts.append(f"\x1b[38;2;{code[0]};{code[1]};{code[2]}m"
                             f"\x1b[48;2;{code[3]};{code[4]};{code[5]}m")
                prev = code
            parts.append("▀")
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


_KEY_HELP = ("WASD+QE move | arrows/IJKL look | +/- speed | "
             "n denoise | t tonemap | ESC/x quit")
_ARROWS = {"A": "up", "B": "down", "C": "right", "D": "left"}


def _read_keys(timeout: float):
    """Drain pending stdin bytes (raw mode); decode arrow escapes.

    Reads with unbuffered os.read on the fd select() watches: sys.stdin's
    buffered layer would slurp whole escape sequences, after which
    select() reports the fd empty and the tail is stranded.
    """
    keys = []
    fd = sys.stdin.fileno()

    def readable(t):
        r, _, _ = select.select([fd], [], [], t)
        return bool(r)

    def read1():
        return os.read(fd, 1).decode("ascii", errors="ignore")

    while True:
        if not readable(timeout):
            return keys
        ch = read1()
        if ch == "":                     # EOF (scripted or piped stdin)
            return keys
        if ch == "\x1b":
            # a full CSI/SS3 sequence up to its final byte (0x40-0x7e):
            # modified arrows, Home or F-keys are consumed whole; a bare
            # ESC (nothing pending) quits
            if not readable(0.01):
                keys.append("esc")
                timeout = 0.0
                continue
            lead = read1()
            if lead not in ("[", "O"):
                keys.append("esc")       # ESC + ordinary key: ESC
                timeout = 0.0
                continue
            seq = ""
            while readable(0.01):
                b = read1()
                if b == "":
                    break
                seq += b
                if "\x40" <= b <= "\x7e":   # final byte
                    break
            # plain or modified arrows end in A/B/C/D
            keys.append(_ARROWS.get(seq[-1:], ""))
        else:
            keys.append(ch.lower())
        timeout = 0.0   # drain without blocking further


_MOVES = {"w": "forward", "s": "backward", "a": "left", "d": "right",
          "q": "down", "e": "up"}
_LOOKS = {"left": (-40.0, 0.0), "j": (-40.0, 0.0),
          "right": (40.0, 0.0), "l": (40.0, 0.0),
          "up": (0.0, 40.0), "i": (0.0, 40.0),
          "down": (0.0, -40.0), "k": (0.0, -40.0)}
_TONEMAPS = ("gamma", "reinhard", "aces")


def run_interactive(renderer, cols: int = 100, rows: int = 40,
                    max_frames: int = 0) -> int:
    """Drive a render.Renderer from the terminal; returns the frames
    rendered. max_frames: stop after that many (0: until quit)."""
    import termios
    import tty

    cam = renderer.camera
    fd = sys.stdin.fileno()
    try:
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)
    except termios.error:      # piped stdin: render-only preview
        old = None
    n = 0
    try:
        sys.stdout.write("\x1b[2J")        # clear once
        t_prev = time.perf_counter()
        while True:
            now = time.perf_counter()
            dt = min(now - t_prev, 0.25)
            t_prev = now
            for k in (_read_keys(0.0) if old is not None else ()):
                if k in ("esc", "x"):
                    raise KeyboardInterrupt
                if k in _MOVES:
                    cam.process_keyboard(_MOVES[k], dt)
                elif k in _LOOKS:
                    cam.process_mouse(*_LOOKS[k])
                elif k == "n":
                    renderer.denoise = (not renderer.denoise
                                        and renderer.cfg.denoise)
                elif k == "t":
                    renderer.tonemap = _TONEMAPS[
                        (_TONEMAPS.index(renderer.tonemap) + 1)
                        % len(_TONEMAPS)]
                elif k == "+":
                    cam.speed *= 1.5
                elif k == "-":
                    cam.speed /= 1.5
            film = renderer.step()
            n += 1
            body = frame_to_ansi(renderer.display() * 255.0, cols, rows - 1)
            sys.stdout.write("\x1b[H" + body +
                             f"\x1b[0m\nframe {film.frame:4d}  "
                             f"spp {film.frame * renderer.cfg.spp:5d}  "
                             f"{_KEY_HELP}\x1b[K")
            sys.stdout.flush()
            if max_frames and n >= max_frames:
                return n
    except KeyboardInterrupt:
        return n
    finally:
        if old is not None:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")
