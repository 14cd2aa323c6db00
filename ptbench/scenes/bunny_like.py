"""bunny_like: a perturbed icosphere on a ground plane under a ceiling
light."""

from ptbench.scenes.procedural import bunny_like as generate  # noqa: F401
