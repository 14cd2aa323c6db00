"""The plain reference: a per-lane path tracer and brute-force ray queries.

Plain PyTorch and numpy. It imports nothing of the program: it builds
its own tables (vertex normals, light CDF, per-material texels, env-map
CDFs, Baldwin-Weber rows) from the benchmark's SceneSpec, draws its own
random numbers (the counter-based PCG4D the estimator is defined by)
and intersects every ray against every triangle. `dtype` selects the
precision of its floating-point work (float32; bfloat16 for the
control).
"""
