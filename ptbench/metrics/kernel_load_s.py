"""kernel_load_s: seconds in the program's pt.kernel_load spans during
set-up - cuda_build.load's nvcc builds and dlopens (ptbench.stages),
read once set-up ends, in every run."""


def read(rec):
    return rec.spans.get("kernel_load")
