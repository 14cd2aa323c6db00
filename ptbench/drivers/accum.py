"""Progressive accumulation: a static camera (the configuration's
`camera`) and a closed loop of Renderer.step(), each followed by a
device synchronize, folding frame_batch frames into the film.

What the reference judges is the film (Renderer.film.accum after every
frame folded) at `film_pixels` pixels drawn from the seed: the
reference's value of a pixel is its mean over the same sample ids.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ptbench import checks, spec
from ptbench.reference.camera import Camera


class Driver:
    def __init__(self, renderer, cell, seed, sync):
        self.r = renderer
        self.cell = cell
        self.sync = sync
        cam = cell.config["camera"]
        self.camera = Camera(cam["position"], cam["target"])

    def step(self):
        with record_function("ptbench.step"):
            self.r.step()
            self.sync()

    def frames(self) -> int:
        return self.r.film.frame

    def outputs(self, seed):
        t = self.cell.traffic
        ids = checks.sample_pixels(seed, t["height"] * t["width"],
                                   t["film_pixels"], 3)
        acc = self.r.film.accum.reshape(-1, 3)
        return {"pixel_ids": ids, "frames": self.r.film.frame,
                "film_pixels": acc[torch.as_tensor(
                    ids, device=acc.device)].cpu().numpy()}


def reference(tb, cell, seed, produced):
    rc = spec.render_fields(cell, seed)
    return {"film_pixels": checks.reference_pixels(
        tb, rc, produced["camera"], produced["pixel_ids"],
        produced["frames"] * rc["spp"])}


def errors(produced, ref):
    return checks.pixel_errors(np.asarray(produced["film_pixels"]),
                               ref["film_pixels"])
