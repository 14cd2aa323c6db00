"""Recording what the timed path traced, from the benchmark's side.

HitCapture wraps the two entry points of every intersector route while
the window runs, by module attribute, as the program calls them: the
cluster route's pathtracer_torch.kernels.packet.intersect_clusters and
occluded_clusters (render.make_intersectors), the bvh route's
kernels.traverse.intersect_bvh and occluded_bvh (the same), and the
brute route's kernels.intersect.intersect_brute and occluded_brute
(accel.bruteforce, which render.make_intersectors also takes for scenes
of at most 256 triangles). Of every captured call it keeps a strided
sample of lanes - rays, bounds and the answers the route gave - as
small device gathers, with no host sync: a scalar t_max is filled on
the device, never copied from the host. K2Capture wraps
kernels.sweep.sweep_closest for one step and keeps the arguments of a
stride sample of its chunks.
"""

from __future__ import annotations

import importlib

import torch

# (module of pathtracer_torch.kernels, attribute, kind, positions of the
# call's o, d, t_min and t_max, each passed by that name where the call
# gives fewer positional arguments; an occlusion call has no t_min)
ENTRY_POINTS = (
    ("packet", "intersect_clusters", "closest", (1, 2, 3, 4)),
    ("packet", "occluded_clusters", "occluded", (1, 2, 3)),
    ("traverse", "intersect_bvh", "closest", (1, 2, 3, 4)),
    ("traverse", "occluded_bvh", "occluded", (1, 2, 3)),
    ("intersect", "intersect_brute", "closest", (0, 1, 5, 6)),
    ("intersect", "occluded_brute", "occluded", (0, 1, 2)),
)

CLOSEST_ARGS = ("o", "d", "t_min", "t_max")
OCCLUDED_ARGS = ("o", "d", "t_max")


def _args(a, kw, pos, names):
    return [a[p] if p < len(a) else kw[n] for p, n in zip(pos, names)]


def _t_max_at(t_max, i, o):
    """t_max of the lanes i: a per-ray (or 0-d) tensor gathered, a
    Python scalar filled on o's device (torch.full launches a fill; a
    torch.as_tensor of a scalar would be a blocking host-to-device
    copy, a sync the program does not make)."""
    if torch.is_tensor(t_max):
        return t_max.to(device=o.device, dtype=o.dtype).expand(
            o.shape[0])[i]
    return torch.full(i.shape, float(t_max), dtype=o.dtype, device=o.device)


class HitCapture:
    def __init__(self, per_call: int, seed: int):
        self.per_call = per_call
        self.seed = int(seed)
        self.closest = []
        self.occluded = []
        self.on = False
        self.calls = 0
        self._real = []
        for mod, attr, kind, pos in ENTRY_POINTS:
            m = importlib.import_module(f"pathtracer_torch.kernels.{mod}")
            self._real.append((m, attr, kind, pos, getattr(m, attr)))

    def _lanes(self, n, device):
        stride = max(1, n // self.per_call)
        off = (self.seed * 2654435761 + self.calls * 40503) % stride
        self.calls += 1
        return (torch.arange(min(n, self.per_call), device=device) * stride
                + off).clamp(max=n - 1)

    def _closest(self, real, pos):
        def call(*a, **kw):
            hit = real(*a, **kw)
            o, d, t_min, t_max = _args(a, kw, pos, CLOSEST_ARGS)
            if self.on and o.shape[0]:
                i = self._lanes(o.shape[0], o.device)
                self.closest.append(dict(
                    o=o[i], d=d[i], t_min=float(t_min),
                    t_max=_t_max_at(t_max, i, o), t=hit.t[i],
                    tri=hit.tri[i], u=hit.u[i], v=hit.v[i]))
            return hit
        return call

    def _occluded(self, real, pos):
        def call(*a, **kw):
            out = real(*a, **kw)
            o, d, t_max = _args(a, kw, pos, OCCLUDED_ARGS)
            if self.on and o.shape[0]:
                i = self._lanes(o.shape[0], o.device)
                blocked = out[0] if isinstance(out, tuple) else out
                self.occluded.append(dict(
                    o=o[i], d=d[i], t_max=_t_max_at(t_max, i, o),
                    blocked=blocked[i]))
            return out
        return call

    def __enter__(self):
        for mod, attr, kind, pos, real in self._real:
            wrap = self._closest if kind == "closest" else self._occluded
            setattr(mod, attr, wrap(real, pos))
        return self

    def __exit__(self, *exc):
        for mod, attr, _, _, real in self._real:
            setattr(mod, attr, real)
        return False

    def gathered(self):
        """The captured lanes as one dict per kind, parked lanes
        (origin at the 1e30 park) dropped."""
        out = {}
        for kind, recs in (("closest", self.closest),
                           ("occluded", self.occluded)):
            if not recs:
                out[kind] = None
                continue
            keys = [k for k in recs[0] if k != "t_min"]
            cat = {k: torch.cat([r[k] for r in recs]) for k in keys}
            live = cat["o"][:, 0] < 1e29
            out[kind] = {k: v[live] for k, v in cat.items()}
            if kind == "closest":
                t_min = {r["t_min"] for r in recs}
                if len(t_min) != 1:
                    raise ValueError(f"closest-hit calls with t_min "
                                     f"{sorted(t_min)}: one was expected")
                out[kind]["t_min"] = t_min.pop()
        return out


class K2Capture:
    """Arguments of every stride-th K2 launch (at most `keep`) while on."""

    def __init__(self, sweep, stride: int, keep: int):
        self.sweep = sweep
        self.stride = stride
        self.keep = keep
        self.chunks = []
        self.seen = 0
        self._real = sweep.sweep_closest

    def __enter__(self):
        real = self._real

        def call(st, si, rays, t_cap, accel, t_min):
            if self.seen % self.stride == 0 and len(self.chunks) < self.keep:
                self.chunks.append((st.clone(), si.clone(), rays.clone(),
                                    t_cap.clone(), accel, float(t_min)))
            self.seen += 1
            return real(st, si, rays, t_cap, accel, t_min)

        self.sweep.sweep_closest = call
        return self

    def __exit__(self, *exc):
        self.sweep.sweep_closest = self._real
        return False
