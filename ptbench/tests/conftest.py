"""Tiny versions of the cells for the CPU, and the card fixture."""

from __future__ import annotations

import copy
import json
import os

import pytest

from ptbench import spec

ROOT = spec.ROOT

# per cell: the traffic at 32 px and a smaller scene of the same kind
TINY_SCENES = {
    "sponza_textured": dict(generator="sponza_like",
                            args=dict(target_tris=1000, seed=0,
                                      textured=True)),
    "envmap_textured": dict(generator="envmap_scene",
                            args=dict(subdivisions=2, tex_size=32, env_h=32,
                                      env_w=64)),
}


def tiny_cell(name: str, **traffic):
    """Cell `name` of BENCHMARK.json at 32x32 on a small scene (one
    sample a frame), for runs on the CPU."""
    c = copy.deepcopy(spec.cell(name, root=ROOT))
    c.config["scene"] = TINY_SCENES[c.config_name]
    c.config["render"]["spp"] = 1
    c.traffic.update(width=32, height=32, film_pixels=24, warmup_steps=1,
                     trace_steps=1, **traffic)
    return c


def last_json_line(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _keep_env():
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)
