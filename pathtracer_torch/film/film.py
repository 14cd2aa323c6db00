"""Film: progressive accumulation, display transforms, PNG output, checkpoints.

Counterpart of pathtracer/film/film.py. The accumulation recurrence is
raygen.rgen:300-302 in f32, accum' = (accum * frame + radiance) /
(frame + 1); display applies gamma 1/2.2 (raygen.rgen:305-306), after
an optional reinhard or aces tone map. PNGs are written through the
native encoder (utils/native.py). A checkpoint is an .npz with the JAX
package's keys (`accum`, `frame`), so either package resumes the
other's; the counter-based RNG makes a resume exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pathtracer_torch import tracing


@dataclasses.dataclass
class Film:
    """Progressive film state. accum: f32[H,W,3] linear; frame: host int."""

    accum: torch.Tensor
    frame: int


def new_film(width: int, height: int, *, device) -> Film:
    return Film(accum=torch.zeros((height, width, 3), dtype=torch.float32,
                                  device=device), frame=0)


def accumulate(film: Film, frame_radiance) -> Film:
    """One progressive step: raygen.rgen:300-302 recurrence in f32."""
    f = float(film.frame)
    with tracing.span("pt.film"):
        accum = (film.accum * f + frame_radiance) / (f + 1.0)
    return Film(accum=accum, frame=film.frame + 1)


def accumulate_many(film: Film, radiance_sum, k: int) -> Film:
    """Fold k frames' summed radiance in one step: (accum*f + sum)/(f+k)."""
    f = float(film.frame)
    with tracing.span("pt.film"):
        accum = (film.accum * f + radiance_sum) / (f + float(k))
    return Film(accum=accum, frame=film.frame + int(k))


def reset(film: Film) -> Film:
    """Accumulation reset on camera move (main.cpp:678-681 semantics)."""
    return Film(accum=torch.zeros_like(film.accum), frame=0)


def to_display(linear, tonemap: str = "gamma"):
    """Display transform, clipped to [0, 1] (film.py:71-91).

    "gamma"    pow(x, 1/2.2), the reference's transform;
    "reinhard" x / (1 + x), then gamma;
    "aces"     Narkowicz's fit of the ACES RRT+ODT, then gamma.
    """
    x = torch.clamp(linear, min=0.0)
    if tonemap == "reinhard":
        x = x / (1.0 + x)
    elif tonemap == "aces":
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        x = (x * (a * x + b)) / (x * (c * x + d) + e)
    elif tonemap != "gamma":
        raise ValueError(f"unknown tonemap {tonemap!r} "
                         "(gamma|reinhard|aces)")
    return torch.clamp(x ** (1.0 / 2.2), 0.0, 1.0)


def rmse(a, b) -> float:
    """RMSE between two images, in float64 (the BASELINE accuracy metric)."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def write_png(path: str, image) -> None:
    """Write f32 [0,1] or u8 [H,W,3] / [H,W] to PNG (native encoder)."""
    from pathtracer_torch.utils import native

    arr = image.detach().cpu().numpy() if isinstance(image, torch.Tensor) \
        else np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    data = native.png_encode(arr)
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Read a PNG as f32 [H, W, C] / 255, as the JAX package's read_png
    gives it: an 8-bit non-interlaced PNG in the file's own channels (1
    gray, squeezed to [H, W]; 2 gray + alpha; 3 RGB or palette; 4 RGBA or
    palette with tRNS), and every other PNG as PIL's array of the opened
    image, which the JAX package falls back to: palette indices [H, W] of
    a sub-8-bit or interlaced palette PNG, 0/1 of a 1-bit gray, unclipped
    16-bit gray, RGBA of 16-bit gray + alpha, and else the pixels PIL's
    convert gives, in the file's own channels."""
    from pathtracer_torch.utils import native

    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    _, _, ch = native.image_info(raw, path)
    depth, color, interlace = raw[24], raw[25], raw[28]
    if (color == 3 and (depth != 8 or interlace)) or (
            color == 0 and depth in (1, 16)):
        return native.png_samples(raw, path)[..., 0].astype(
            np.float32) / 255.0
    rgba = native.image_rgba(raw, path).astype(np.float32) / 255.0
    if color == 4 and depth == 16:
        return rgba
    if ch == 1:
        return rgba[..., 0]
    return rgba[..., [0, 3]] if ch == 2 else rgba[..., :ch]


def save_checkpoint(path: str, film: Film) -> None:
    """Write the film as .npz: accum f32[H, W, 3] and frame (a scalar)."""
    np.savez(path, accum=film.accum.detach().cpu().numpy(),
             frame=np.asarray(film.frame, np.int32))


def load_checkpoint(path: str, *, device) -> Film:
    data = np.load(path)
    return Film(accum=torch.from_numpy(np.array(data["accum"], np.float32))
                .to(device), frame=int(data["frame"]))
