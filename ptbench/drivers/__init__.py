"""Drivers of the Renderer, one module a kind, found by name.

A traffic mix's file (ptbench/traffic/<mix>.json) names its driver;
ptbench/drivers/<driver>.py holds it, so a new kind of traffic is a new
module and a new mix file. A driver module provides:

  Driver(renderer, cell, seed, sync)
      .step()      one step of the traffic, ending in `sync`
      .frames()    frames completed so far (what frame_ms divides by)
      .camera      the benchmark's own copy of the view
                   (ptbench.reference.camera), kept in step with the
                   program's, so the reference needs nothing of it
      .spans       optional: {name: [seconds, ...]} of the driver's own
                   spans (a display driver's readback, say); run.py
                   clears it when set-up ends and copies the window's
                   into Record.spans as driver.<name>, for a reader
      .outputs(seed) -> dict of what the window produced that the
                   reference judges, read while the program's state lives
  reference(tb, cell, seed, produced) -> dict: the same fields of
      `produced`, worked out by the reference from its tables `tb`
  errors(produced, ref) -> per-item relative error (float64 tensor)

run.py and calibrate.py call only these; the control is `reference`
on tables in the lower precision, put in the program's place.
"""

from __future__ import annotations

import importlib


def module(name: str):
    """ptbench/drivers/<name>.py."""
    return importlib.import_module(f"{__name__}.{name}")


def make(renderer, cell, seed, sync):
    return module(cell.traffic["driver"]).Driver(renderer, cell, seed, sync)
