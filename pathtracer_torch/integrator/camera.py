"""Camera and primary rays (counterpart of pathtracer/integrator/camera.py).

`Camera` is the host-side FPS controller (numpy, y-up); `CameraState`
holds its basis as f32[3] tensors on the render device. Primary rays
follow raygen.rgen:103-119 with image row 0 at the top; aperture > 0
adds thin-lens depth of field.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pathtracer_torch import tracing
from pathtracer_torch.sampling import rng
from pathtracer_torch.utils import vmath


@dataclasses.dataclass
class CameraState:
    """Device-side camera basis. All f32[3]."""

    position: torch.Tensor
    front: torch.Tensor
    up: torch.Tensor
    right: torch.Tensor


class Camera:
    """Host-side FPS camera (render/camera.{h,cpp} semantics, y-up)."""

    WORLD_UP = np.array([0.0, 1.0, 0.0], np.float32)

    def __init__(self, position=(0.0, 0.0, 0.0), yaw=-90.0, pitch=0.0,
                 speed=8.0, sensitivity=0.1):
        self.position = np.asarray(position, np.float32).copy()
        self.yaw = float(yaw)
        self.pitch = float(pitch)
        self.speed = float(speed)
        self.sensitivity = float(sensitivity)
        self.moved = True
        self._update_basis()

    def _update_basis(self):
        cy, sy = (math.cos(math.radians(self.yaw)),
                  math.sin(math.radians(self.yaw)))
        cp, sp = (math.cos(math.radians(self.pitch)),
                  math.sin(math.radians(self.pitch)))
        front = np.array([cy * cp, sp, sy * cp], np.float32)
        self.front = front / np.linalg.norm(front)
        right = np.cross(self.front, self.WORLD_UP)
        self.right = (right / np.linalg.norm(right)).astype(np.float32)
        up = np.cross(self.right, self.front)
        self.up = (up / np.linalg.norm(up)).astype(np.float32)

    def process_mouse(self, dx: float, dy: float):
        """Mouse-look: camera.cpp:29-41 (pitch clamped to +/-89 deg)."""
        self.yaw += dx * self.sensitivity
        self.pitch = float(np.clip(self.pitch + dy * self.sensitivity,
                                   -89.0, 89.0))
        self._update_basis()
        self.moved = True

    def process_keyboard(self, direction: str, dt: float):
        """WASD translation: camera.cpp:18-27."""
        v = self.speed * dt
        step = {
            "forward": self.front, "backward": -self.front,
            "left": -self.right, "right": self.right,
            "up": self.up, "down": -self.up,
        }[direction]
        self.position = (self.position + step * v).astype(np.float32)
        self.moved = True

    def look_at(self, target):
        """Aim the camera at a world-space point."""
        d = np.asarray(target, np.float32) - self.position
        d = d / np.linalg.norm(d)
        self.pitch = math.degrees(math.asin(float(np.clip(d[1], -1, 1))))
        self.yaw = math.degrees(math.atan2(float(d[2]), float(d[0])))
        self._update_basis()
        self.moved = True

    def state(self, *, device) -> CameraState:
        t = lambda a: tracing.device_tensor(  # noqa: E731
            np.asarray(a, np.float32), device)
        return CameraState(position=t(self.position), front=t(self.front),
                           up=t(self.up), right=t(self.right))


def generate_primary_rays(cam: CameraState, width: int, height: int,
                          fov_deg: float, pixel_ids, sample_ids, seed=0,
                          sampler="pcg", aperture: float = 0.0,
                          focus_dist: float = 0.0):
    """Jittered primary rays -> (origins f32[N,3], directions f32[N,3]).

    pixel_ids: int[N] flat row-major pixel index (row 0 = image top);
    sample_ids: int[N] global sample index (frame * spp + s).
    With aperture > 0 and focus_dist > 0, a thin lens (camera.py:103-156):
    the origin moves on a disk of that diameter in the lens plane and the
    ray re-aims at the pixel's point on the plane at distance focus_dist
    along cam.front. The lens sample is lanes 2-3 of the same SALT_JITTER
    draw, so pinhole rays are unchanged.
    """
    px = (pixel_ids % width).to(torch.float32)
    py = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    uj = rng.uniform4(pixel_ids, sample_ids, 0, rng.SALT_JITTER, seed,
                      sampler)
    jx, jy = uj[..., 0], uj[..., 1]
    u = (px + jx) / width * 2.0 - 1.0
    v = (py + jy) / height * 2.0 - 1.0
    aspect = width / height
    tan_fov = math.tan(math.radians(fov_deg * 0.5))
    d = (cam.front[None, :]
         + cam.right[None, :] * (u * aspect * tan_fov)[:, None]
         - cam.up[None, :] * (v * tan_fov)[:, None])
    d = d * torch.rsqrt(vmath.dotk(d, d))
    o = cam.position[None, :].expand_as(d)
    if aperture > 0.0 and focus_dist > 0.0:
        t_focus = focus_dist / vmath.dotk(d, cam.front[None, :])
        p_focus = o + d * t_focus
        r = 0.5 * aperture * torch.sqrt(uj[..., 2])
        phi = 2.0 * math.pi * uj[..., 3]
        lens = (cam.right[None, :] * (r * torch.cos(phi))[:, None]
                + cam.up[None, :] * (r * torch.sin(phi))[:, None])
        o = o + lens
        d = p_focus - o
        d = d * torch.rsqrt(vmath.dotk(d, d))
    return o, d
