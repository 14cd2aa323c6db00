"""The benchmark of pathtracer_torch (python3 -m ptbench; see run.py).

Nothing here imports jax, the JAX package or the root bench.py; the
program is imported only inside a run, and the reference
(ptbench.reference) never imports it.
"""
