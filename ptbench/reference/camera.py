"""The FPS camera (y-up; yaw and pitch in degrees) and pinhole primary
rays with per-(pixel, sample) jitter, image row 0 at the top."""

from __future__ import annotations

import math

import numpy as np
import torch

from ptbench.reference import rng, vmath

WORLD_UP = np.array([0.0, 1.0, 0.0], np.float32)


class Camera:
    """Position, yaw, pitch and the basis they give (float32)."""

    def __init__(self, position, target=None, yaw=-90.0, pitch=0.0):
        self.position = np.asarray(position, np.float32).copy()
        self.yaw, self.pitch = float(yaw), float(pitch)
        if target is not None:
            d = np.asarray(target, np.float32) - self.position
            d = d / np.linalg.norm(d)
            self.pitch = math.degrees(math.asin(float(np.clip(d[1], -1, 1))))
            self.yaw = math.degrees(math.atan2(float(d[2]), float(d[0])))
        self._basis()

    def _basis(self):
        cy, sy = (math.cos(math.radians(self.yaw)),
                  math.sin(math.radians(self.yaw)))
        cp, sp = (math.cos(math.radians(self.pitch)),
                  math.sin(math.radians(self.pitch)))
        front = np.array([cy * cp, sp, sy * cp], np.float32)
        self.front = front / np.linalg.norm(front)
        right = np.cross(self.front, WORLD_UP)
        self.right = (right / np.linalg.norm(right)).astype(np.float32)
        up = np.cross(self.right, self.front)
        self.up = (up / np.linalg.norm(up)).astype(np.float32)


def primary_rays(cam: Camera, width, height, fov_deg, pixel, sample, seed,
                 dtype):
    """Jittered pinhole rays (o, d) [N, 3] for int64 pixel/sample [N]."""
    dev = pixel.device

    def vec(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev).to(dtype)

    px = (pixel % width).to(dtype)
    py = torch.div(pixel, width, rounding_mode="floor").to(dtype)
    uj = rng.uniform4(pixel, sample, 0, rng.SALT_JITTER, seed, dtype)
    u = (px + uj[:, 0]) / width * 2.0 - 1.0
    v = (py + uj[:, 1]) / height * 2.0 - 1.0
    aspect = width / height
    tan_fov = math.tan(math.radians(fov_deg * 0.5))
    d = (vec(cam.front)[None, :]
         + vec(cam.right)[None, :] * (u * aspect * tan_fov)[:, None]
         - vec(cam.up)[None, :] * (v * tan_fov)[:, None])
    d = d * torch.rsqrt(vmath.dotk(d, d))
    return vec(cam.position)[None, :].expand_as(d), d
