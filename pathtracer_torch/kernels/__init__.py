"""Traversal kernels and their host side.

LAUNCHES counts kernel launches per kernel; it is
pathtracer_torch.tracing's launch table (the kernels it lists and the
rule by which a wrapper counts are there), and reset_launch_counts
is tracing's.
"""

from pathtracer_torch.tracing import (  # noqa: F401
    LAUNCHES, reset_launch_counts)
