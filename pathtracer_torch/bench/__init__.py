"""The port's bench path (counterpart of pathtracer/bench/ and bench.py).

harness: timed frames and their median-window throughput; pair_metrics:
the bounce-1 schedule statistics and the sweep's cost model at the
card's own rate; sweep_attrib, bf16_probe, cond_probe: the drivers of
the probe kernels P1-P3 (kernels/probes.py); configs: the five BASELINE
configs and their golden gate (benchmarks/run_configs.py). `python -m
pathtracer_torch.bench` prints bench.py's JSON line, `python -m
pathtracer_torch.bench.configs` run_configs.py's lines.
"""
