"""The control (the reference in bfloat16 put in the program's place)
fails the comparison; on the card at a small size too."""

from __future__ import annotations

import pytest

from ptbench import calibrate, checks, run
from ptbench.tests.conftest import tiny_cell

SEED = 4242


def readings(name, device, control):
    c = tiny_cell(name)
    spec, scene = run.build_scene(c, device, run.Record())
    _, produced = calibrate.produce(c, scene, SEED, 0.1, device)
    if control:
        produced = calibrate.control(c, spec, SEED, produced, device)
    numbers, _ = run.judge(c, spec, SEED, produced, device)
    return numbers


def fails(numbers):
    return any(numbers[k] > lim for k, lim in checks.LIMITS.items())


@pytest.mark.parametrize("name", ["sponza.accum_1080p", "envmap.accum_1024"])
def test_control_fails_and_program_passes_on_cpu(name):
    assert fails(readings(name, "cpu", control=True))
    assert not fails(readings(name, "cpu", control=False))


@pytest.mark.cuda
def test_control_fails_on_the_card(cuda_device):
    assert fails(readings("sponza.accum_1080p", cuda_device, control=True))
    assert not fails(readings("sponza.accum_1080p", cuda_device,
                              control=False))
