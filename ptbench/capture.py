"""Recording what the timed path traced, from the benchmark's side.

HitCapture wraps the packet layer's two entry points
(pathtracer_torch.kernels.packet.intersect_clusters and
occluded_clusters, which render.make_intersectors calls by module
attribute) while the window runs: of every captured call it keeps a
strided sample of lanes - rays, bounds and the answers the accel,
packet and kernel layers gave - as small device gathers, with no host
sync. K2Capture wraps kernels.sweep.sweep_closest for one step and keeps
the arguments of a stride sample of its chunks.
"""

from __future__ import annotations

import torch


class HitCapture:
    def __init__(self, packet, per_call: int, seed: int):
        self.packet = packet
        self.per_call = per_call
        self.seed = int(seed)
        self.closest = []
        self.occluded = []
        self.on = False
        self.calls = 0
        self._real = (packet.intersect_clusters, packet.occluded_clusters)

    def _lanes(self, n, device):
        stride = max(1, n // self.per_call)
        off = (self.seed * 2654435761 + self.calls * 40503) % stride
        self.calls += 1
        return (torch.arange(min(n, self.per_call), device=device) * stride
                + off).clamp(max=n - 1)

    def __enter__(self):
        real_i, real_o = self._real

        def intersect(accel, o, d, t_min, t_max, *a, **kw):
            hit = real_i(accel, o, d, t_min, t_max, *a, **kw)
            if self.on and o.shape[0]:
                i = self._lanes(o.shape[0], o.device)
                tm = torch.as_tensor(t_max, dtype=o.dtype, device=o.device)
                self.closest.append(dict(
                    o=o[i], d=d[i], t_min=float(t_min),
                    t_max=tm.expand(o.shape[0])[i], t=hit.t[i],
                    tri=hit.tri[i], u=hit.u[i], v=hit.v[i]))
            return hit

        def occluded(accel, o, d, t_max, *a, **kw):
            out = real_o(accel, o, d, t_max, *a, **kw)
            if self.on and o.shape[0]:
                i = self._lanes(o.shape[0], o.device)
                blocked = out[0] if isinstance(out, tuple) else out
                tm = torch.as_tensor(t_max, dtype=o.dtype, device=o.device)
                self.occluded.append(dict(
                    o=o[i], d=d[i], t_max=tm.expand(o.shape[0])[i],
                    blocked=blocked[i]))
            return out

        self.packet.intersect_clusters = intersect
        self.packet.occluded_clusters = occluded
        return self

    def __exit__(self, *exc):
        self.packet.intersect_clusters, self.packet.occluded_clusters = \
            self._real
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
