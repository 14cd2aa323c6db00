"""Brute-force ray queries: every ray against every triangle's
Baldwin-Weber rows, in blocks of rays so a block's [rays, triangles]
temporaries stay near 2^25 elements."""

from __future__ import annotations

import torch

DET_EPS = 1e-12
BLOCK_ELEMS = 1 << 25


def _test(bw, o, d, t_min):
    """t [R, T] (+inf where no hit in (t_min, inf)), u, v, denom."""
    row = [bw[None, :, i] for i in range(12)]
    nx, ny, nz, dpl, r1x, r1y, r1z, c1, r2x, r2y, r2z, c2 = row
    ox, oy, oz = (o[:, i, None] for i in range(3))
    dx, dy, dz = (d[:, i, None] for i in range(3))
    denom = dx * nx + dy * ny + dz * nz
    ok_det = denom.abs() > DET_EPS
    inv = torch.where(ok_det, torch.reciprocal(denom), 0.0)
    t = (dpl - (ox * nx + oy * ny + oz * nz)) * inv
    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz
    u = r1x * hx + r1y * hy + r1z * hz + c1
    v = r2x * hx + r2y * hy + r2z * hz + c2
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return torch.where(ok, t, torch.inf), u, v, denom


def _blocks(n_rays, n_tris):
    step = max(1, BLOCK_ELEMS // max(1, n_tris))
    return [(a, min(n_rays, a + step)) for a in range(0, n_rays, step)]


def closest(bw, o, d, t_min, t_max):
    """Closest hit with t_min < t < t_max (t_max [N] or a scalar) ->
    (t [N] +inf on a miss, tri int64 [N] -1 on a miss, u, v)."""
    n = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=o.dtype, device=o.device
                            ).expand(n)
    out_t = torch.full((n,), torch.inf, dtype=o.dtype, device=o.device)
    out_tri = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    out_u = torch.zeros((n,), dtype=o.dtype, device=o.device)
    out_v = torch.zeros_like(out_u)
    for a, b in _blocks(n, bw.shape[0]):
        t, u, v, _ = _test(bw, o[a:b], d[a:b], t_min)
        t = torch.where(t < t_max[a:b, None], t, torch.inf)
        tb, jb = torch.min(t, dim=1)
        hit = torch.isfinite(tb)
        out_t[a:b] = tb
        out_tri[a:b] = torch.where(hit, jb, -1)
        out_u[a:b] = torch.gather(u, 1, jb[:, None])[:, 0]
        out_v[a:b] = torch.gather(v, 1, jb[:, None])[:, 0]
    return out_t, out_tri, out_u, out_v


def occluded(bw, o, d, t_max):
    """Any front-facing hit (denominator < 0) with 0 < t < t_max -> bool[N]."""
    n = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=o.dtype, device=o.device
                            ).expand(n)
    out = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for a, b in _blocks(n, bw.shape[0]):
        t, _, _, denom = _test(bw, o[a:b], d[a:b], 0.0)
        out[a:b] = (torch.isfinite(t) & (denom < 0.0)
                    & (t < t_max[a:b, None])).any(dim=1)
    return out


def triangle(bw, tri, o, d, t_min, t_max):
    """Each ray against its own triangle tri [N] -> (t, u, v, hit)."""
    rows = bw[tri.clamp(min=0)]
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    nx, ny, nz, dpl, r1x, r1y, r1z, c1, r2x, r2y, r2z, c2 = rows.unbind(-1)
    denom = dx * nx + dy * ny + dz * nz
    ok_det = denom.abs() > DET_EPS
    inv = torch.where(ok_det, torch.reciprocal(denom), 0.0)
    t = (dpl - (ox * nx + oy * ny + oz * nz)) * inv
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
    u = r1x * hx + r1y * hy + r1z * hz + c1
    v = r2x * hx + r2y * hy + r2z * hz + c2
    hit = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
           & (t < t_max) & (tri >= 0))
    return t, u, v, hit
