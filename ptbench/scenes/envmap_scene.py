"""envmap_scene: bunny_like with a checker on the body under an HDR sky
with a sun disc."""

from ptbench.scenes.procedural import envmap_scene as generate  # noqa: F401
