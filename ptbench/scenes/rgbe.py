"""Radiance RGBE pixel codec (numpy), frozen from pathtracer_torch/scene/hdr.py.

encode then decode is what writing a .hdr file and reading it back gives
(the file's run-length coding is lossless), so a sky quantised here is
the sky a renderer would load from that file.
"""

from __future__ import annotations

import numpy as np


def decode(rgbe: np.ndarray) -> np.ndarray:
    """RGBE u8 [..., 4] -> linear f32 [..., 3]."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def encode(rgb: np.ndarray) -> np.ndarray:
    """Linear f32 [..., 3] -> RGBE u8 [..., 4]."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    m, e = np.frexp(maxc)
    scale = np.where(maxc < 1e-32, 0.0, np.ldexp(1.0, 8) * m / np.maximum(
        maxc, 1e-32))
    q = np.minimum(rgb * scale[..., None], 255.0).astype(np.uint8)
    eb = np.where(maxc < 1e-32, 0, e + 128).astype(np.uint8)
    return np.concatenate([q, eb[..., None]], axis=-1)
