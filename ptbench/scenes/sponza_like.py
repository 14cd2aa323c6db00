"""sponza_like: the colonnaded atrium of the headline configuration."""

from ptbench.scenes.procedural import sponza_like as generate  # noqa: F401
