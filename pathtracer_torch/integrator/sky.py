"""Environment lighting, the "miss shader" (counterpart of pathtracer/integrator/sky.py).

Gradient (miss.rmiss:153-156, x sky_gain) and black skies. Hosek-Wilkie
and env maps are not ported yet (ROADMAP.md Queue 1, items 10-11); the
config rejects them.
"""

from __future__ import annotations

import torch

_TOP = (0.6, 0.7, 0.9)
_BOT = (0.02, 0.02, 0.05)


def gradient_sky(d, gain: float = 0.2):
    """Simple vertical gradient (miss.rmiss:153-156) x gain."""
    t = torch.clamp(0.5 * (d[..., 1] + 1.0), 0.0, 1.0)
    top = torch.tensor(_TOP, dtype=torch.float32, device=d.device)
    bot = torch.tensor(_BOT, dtype=torch.float32, device=d.device)
    m = ((1.0 - t) ** 2)[..., None]
    return (top * (1.0 - m) + bot * m) * gain


def sky_radiance(cfg, d):
    """Dispatch on cfg.sky - the miss-shader entry point."""
    if cfg.sky == "black":
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32,
                           device=d.device)
    if cfg.sky == "gradient":
        return gradient_sky(d, cfg.sky_gain)
    raise ValueError(f"sky={cfg.sky!r} is not ported "
                     "(ROADMAP.md Queue 1, items 10-11)")
