"""Film: progressive accumulation, display transform, PNG output.

Counterpart of pathtracer/film/film.py. The accumulation recurrence is
raygen.rgen:300-302 in f32, accum' = (accum * frame + radiance) /
(frame + 1); display applies gamma 1/2.2 (raygen.rgen:305-306). PNGs are
written through the native encoder (utils/native.py). Checkpoints and
the reinhard/aces tone maps are not ported yet (ROADMAP.md Queue 1,
items 4 and 2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
    accum = (film.accum * f + frame_radiance) / (f + 1.0)
    return Film(accum=accum, frame=film.frame + 1)


def accumulate_many(film: Film, radiance_sum, k: int) -> Film:
    """Fold k frames' summed radiance in one step: (accum*f + sum)/(f+k)."""
    f = float(film.frame)
    accum = (film.accum * f + radiance_sum) / (f + float(k))
    return Film(accum=accum, frame=film.frame + int(k))


def to_display(linear, tonemap: str = "gamma"):
    """pow(x, 1/2.2) clipped to [0, 1] (the reference's transform)."""
    if tonemap != "gamma":
        raise ValueError(f"tonemap {tonemap!r} is not ported "
                         "(ROADMAP.md Queue 1, item 2)")
    x = torch.clamp(linear, min=0.0)
    return torch.clamp(x ** (1.0 / 2.2), 0.0, 1.0)


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
