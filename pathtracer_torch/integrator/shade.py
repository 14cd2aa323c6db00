"""K10: a bounce's shading in one hand-written kernel (csrc/shade.cu).

`kernel_shades` is the one predicate that sends a bounce of
path.trace_paths to K10 or to the plain chain: K10 on CUDA tensors,
except for the variants no benchmark cell runs, which keep the plain
chain (reference_quirks, sampler="sobol", sky="hosek", the primed
bounce 0 and the bounce that fills the G-buffer; the kernel source says
why); the plain chain on CPU tensors, always.

`Shader` holds a trace_paths call's scene tables and settings as
K10's launch arguments. `bounce` runs K10 after the bounce's closest-hit
call, the two shadow queries on the rays K10 wrote, and the resolve
kernel that adds the unblocked NEE terms; `last` runs K10 on the last
segment (sky and emission only). The state tensors are updated in
place, so the caller hands in tensors no one else holds. Both add the
exact ray count to the state's int64 counter on the device, with no
host sync.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pathtracer_torch.kernels import LAUNCHES, cuda_build

M32 = 0xFFFFFFFF
_SALTS_PER_DEPTH = 12     # sampling/rng.py
# csrc/shade.cu TexKind and SkyKind
_TEX_NONE, _TEX_COMPOSITE, _TEX_STACK, _TEX_BILINEAR = range(4)
_SKY = {"black": 0, "gradient": 1, "envmap": 2}
_P, _L, _I, _U, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_uint, ctypes.c_float)


def kernel_shades(device, cfg, primed: bool = False,
                  gbuffer: bool = False) -> bool:
    """Does K10 shade this bounce? Only on CUDA tensors, and not for
    the variants left to the plain chain: cfg.reference_quirks,
    sampler="sobol", sky="hosek", a primed bounce (primed) or the bounce
    that fills the G-buffer (gbuffer)."""
    return (torch.device(device).type == "cuda"
            and not cfg.reference_quirks and cfg.sampler == "pcg"
            and cfg.sky in _SKY and not primed and not gbuffer)


class ShadeParams(ctypes.Structure):
    """csrc/shade.cu ShadeParams, field for field."""

    _fields_ = [(name, _P) for name in (
        "o", "d", "thr", "rad", "active", "prev_pdf", "pix", "samp",
        "hit_t", "hit_tri", "hit_u", "hit_v", "surf_rows", "mat_rows",
        "tex_comp", "tex_comp_wh", "textures", "tex_wh", "light_cdf",
        "light_v0", "light_v1", "light_v2", "light_n", "light_le",
        "light_area", "light_pdf", "envmap", "env_blocks", "env_mcdf",
        "env_ccdf", "env_pdf", "env_table", "env_s0", "s_orig", "s_dir",
        "s_tmax", "e_orig", "e_dir", "pend_tri", "pend_env", "pend_flags",
        "rays")] + [(name, _L) for name in (
            "n", "surf_cols", "n_lights", "tex_th", "tex_tw", "comp_ch",
            "comp_cw", "env_h", "env_w", "row_iters", "width", "cell",
            "cells_x", "s_win")] + [
        ("pix64", _I), ("samp64", _I), ("depth_salt", _U), ("seed", _U)] + [
        (name, _I) for name in ("last", "tex_kind", "sky_kind", "env_mis",
                                "tri_nee", "env_nee", "rr_on")] + [
        (name, _F) for name in ("sky_gain", "emission_gain", "shadow_eps",
                                "t_min", "rr_lo", "rr_hi", "cutoff",
                                "env_shadow_rr")]


_SIG = {"pt_shade": [_P, _P],
        "pt_shade_resolve": [_L] + [_P] * 7,
        "pt_shade_params_size": []}


def _lib():
    lib = cuda_build.load("shade", _SIG)
    size = lib.pt_shade_params_size()
    if size != ctypes.sizeof(ShadeParams):
        raise RuntimeError(f"K10: ShadeParams is {size} bytes in "
                           f"csrc/shade.cu, {ctypes.sizeof(ShadeParams)} "
                           "in integrator/shade.py")
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _want(name, t, dtype, shape, dev):
    """Raise unless t is a contiguous `dtype` tensor of `shape` on dev."""
    if (t.device != dev or t.dtype not in dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"K10 {name}: want a contiguous {'/'.join(map(str, dtype))} "
            f"tensor of shape {shape} on {dev}, got {t.dtype} "
            f"{tuple(t.shape)} (contiguous: {t.is_contiguous()}) on "
            f"{t.device}")


class Shader:
    """One trace_paths call's launch arguments for K10.

    scene, cfg: the call's; surf_rows / mat_rows: path.pack_surface_rows
    / pack_material_rows; env_nee: env NEE on (path.trace_paths' rule);
    sample_window: the wavefront's sample-id window (the env-NEE table's
    rows a cell); n: lanes.
    """

    def __init__(self, scene, cfg, surf_rows, mat_rows, env_nee: bool,
                 sample_window: int, n: int):
        self.cfg = cfg
        self.n = n
        self.dev = surf_rows.device
        self.tri_nee = scene.has_lights and not cfg.skip_nee
        self.env_nee = env_nee and not cfg.skip_nee
        if mat_rows.shape[1] != 16:
            raise ValueError(f"K10: material rows of {mat_rows.shape[1]} "
                             "columns, want 16")
        use_tex_u = scene.has_textures and cfg.stochastic_texture_filtering
        if not scene.has_textures:
            tex_kind = _TEX_NONE
        elif not use_tex_u:
            tex_kind = _TEX_BILINEAR
        elif scene.tex_comp is not None:
            tex_kind = _TEX_COMPOSITE
        else:
            tex_kind = _TEX_STACK
        # tables K10 reads, kept alive with the Shader
        self._keep = [surf_rows.contiguous(), mat_rows.contiguous()]
        p = ShadeParams()
        tables = dict(
            surf_rows=self._keep[0], mat_rows=self._keep[1],
            textures=scene.textures, tex_wh=scene.tex_wh,
            light_cdf=scene.light_cdf, light_v0=scene.light_v0,
            light_v1=scene.light_v1, light_v2=scene.light_v2,
            light_n=scene.light_normal, light_le=scene.light_emission,
            light_area=scene.light_area, light_pdf=scene.light_pdf,
            envmap=scene.envmap, env_mcdf=scene.env_marginal_cdf,
            env_ccdf=scene.env_cond_cdf, env_pdf=scene.env_pdf)
        if tex_kind == _TEX_COMPOSITE:
            tables.update(tex_comp=scene.tex_comp,
                          tex_comp_wh=scene.tex_comp_wh)
            p.comp_ch, p.comp_cw = scene.tex_comp.shape[1:3]
        if cfg.sky == "envmap" and scene.envmap_blocks is not None:
            tables["env_blocks"] = scene.envmap_blocks
        for name, t in tables.items():
            t = t.contiguous()
            self._keep.append(t)
            setattr(p, name, t.data_ptr())
        p.surf_cols = surf_rows.shape[1]
        p.n_lights = scene.light_cdf.shape[0]
        p.tex_th, p.tex_tw = scene.textures.shape[1:3]
        p.env_h, p.env_w = scene.envmap.shape[:2]
        p.row_iters = int(math.ceil(math.log2(max(scene.env_cond_cdf
                                                  .shape[1], 2)))) + 1
        p.width = cfg.width
        p.cell = cfg.env_nee_cell
        p.cells_x = -(-cfg.width // cfg.env_nee_cell)
        p.s_win = max(1, sample_window)
        p.seed = cfg.seed & M32
        p.tex_kind = tex_kind
        p.sky_kind = _SKY[cfg.sky]
        p.env_mis = int(env_nee)
        p.sky_gain = cfg.sky_gain
        p.emission_gain = cfg.emission_gain
        p.shadow_eps = cfg.shadow_eps
        p.t_min = cfg.t_min
        p.rr_lo = cfg.rr_clamp_lo
        p.rr_hi = cfg.rr_clamp_hi
        p.cutoff = cfg.throughput_cutoff
        p.env_shadow_rr = cfg.env_shadow_rr
        self._base = p

    def _params(self, state, hit, depth: int, last: bool):
        """The launch arguments, and the hit tensors they point at: the
        caller holds those until K10 is launched, since a converted copy
        freed earlier could be handed to an allocation queued before
        K10."""
        o, d, thr, rad, active, prev_pdf, pix, samp, rays = state
        n, dev = self.n, self.dev
        f32, ids = (torch.float32,), (torch.int32, torch.int64)
        for name, t, dt, shape in (
                ("o", o, f32, (n, 3)), ("d", d, f32, (n, 3)),
                ("throughput", thr, f32, (n, 3)),
                ("radiance", rad, f32, (n, 3)),
                ("active", active, (torch.bool,), (n,)),
                ("prev_pdf", prev_pdf, f32, (n,)),
                ("pixel ids", pix, ids, (n,)), ("sample ids", samp, ids, (n,)),
                ("rays", rays, (torch.int64,), ())):
            _want(name, t, dt, shape, dev)
        hit_t, hit_u, hit_v = (x.to(torch.float32).contiguous()
                               for x in (hit.t, hit.u, hit.v))
        hit_tri = hit.tri.to(torch.int32).contiguous()
        p = ShadeParams.from_buffer_copy(self._base)
        for name, t in (("o", o), ("d", d), ("thr", thr), ("rad", rad),
                        ("active", active), ("prev_pdf", prev_pdf),
                        ("pix", pix), ("samp", samp), ("hit_t", hit_t),
                        ("hit_tri", hit_tri), ("hit_u", hit_u),
                        ("hit_v", hit_v), ("rays", rays)):
            setattr(p, name, t.data_ptr())
        p.n = n
        p.pix64 = int(pix.dtype == torch.int64)
        p.samp64 = int(samp.dtype == torch.int64)
        p.depth_salt = (int(depth) * _SALTS_PER_DEPTH) & M32
        p.last = int(last)
        p.rr_on = int(depth > self.cfg.rr_start_depth)
        return p, (hit_t, hit_tri, hit_u, hit_v)

    def _launch(self, p, lib):
        if self.n:
            rc = lib.pt_shade(ctypes.byref(p), cuda_build.stream_ptr(self.dev))
            cuda_build.check_launch(rc, "shade")
            LAUNCHES["shade"] += 1

    def last(self, state, hit, depth: int):
        """The last segment: sky and emission terms, and the count."""
        lib = _lib()
        p, held = self._params(state, hit, depth, last=True)
        self._launch(p, lib)
        del held            # K10 is queued: its hit tensors may go
        return state

    def bounce(self, state, hit, depth: int, occluded_fn, primary: bool,
               env_table=None):
        """K10, the shadow queries on its rays, and the resolve.

        env_table: (table f32[cells * S, 7], s0 int64 scalar) of
        path._env_table where env NEE draws a direction a screen cell
        (cfg.env_nee_cell > 1), else None."""
        n, dev = self.n, self.dev
        lib = _lib()
        p, held = self._params(state, hit, depth, last=False)
        f32 = dict(dtype=torch.float32, device=dev)
        flags = torch.empty((n,), dtype=torch.uint8, device=dev)
        p.tri_nee = int(self.tri_nee)
        p.env_nee = int(self.env_nee)
        p.pend_flags = flags.data_ptr()
        bufs = {}
        if self.tri_nee:
            bufs.update(s_orig=torch.empty((n, 3), **f32),
                        s_dir=torch.empty((n, 3), **f32),
                        s_tmax=torch.empty((n,), **f32),
                        pend_tri=torch.empty((n, 3), **f32))
        if self.env_nee:
            bufs.update(e_orig=torch.empty((n, 3), **f32),
                        e_dir=torch.empty((n, 3), **f32),
                        pend_env=torch.empty((n, 3), **f32))
            if self.cfg.env_nee_cell > 1:
                table, s0 = env_table
                table = table.contiguous()
                _want("env table", table, (torch.float32,),
                      (table.shape[0], 7), dev)
                _want("env s0", s0, (torch.int64,), (), dev)
                p.env_table, p.env_s0 = table.data_ptr(), s0.data_ptr()
        for name, t in bufs.items():
            setattr(p, name, t.data_ptr())
        self._launch(p, lib)
        del held
        blocked_tri = blocked_env = None
        if self.tri_nee:
            blocked_tri = occluded_fn(bufs["s_orig"], bufs["s_dir"],
                                      bufs["s_tmax"], primary=primary)
        if self.env_nee:
            e_tmax = torch.full((n,), 1e18, **f32)
            blocked_env = occluded_fn(bufs["e_orig"], bufs["e_dir"], e_tmax)
        if (self.tri_nee or self.env_nee) and n:
            blocked = [None if b is None else b.to(torch.bool).contiguous()
                       for b in (blocked_tri, blocked_env)]
            rc = lib.pt_shade_resolve(
                n, flags.data_ptr(), *map(_ptr, blocked),
                _ptr(bufs.get("pend_tri")), _ptr(bufs.get("pend_env")),
                state[3].data_ptr(), cuda_build.stream_ptr(dev))
            cuda_build.check_launch(rc, "shade_resolve")
            LAUNCHES["shade_resolve"] += 1
        return state
