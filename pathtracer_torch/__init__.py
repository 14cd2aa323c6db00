"""PyTorch + CUDA port of the path tracer (`pathtracer/` is the JAX reference).

The module tree mirrors `pathtracer/`: each file here is the counterpart
of the file with the same path there. The port imports torch and numpy
only. The three traversal kernels (tile cull, closest sweep, occlusion
sweep) are hand-written CUDA in `csrc/`, built with nvcc at first use
into `_build/`; each wrapper runs its plain PyTorch version for CPU
tensors and launches the kernel (or raises) for CUDA tensors.

Entry points: `render.Renderer(scene, cfg, camera, device=...)`, the
scene files of `scene/gltf.py`, `scene/objload.py` and
`scene/export.py`, `viewer.run_interactive(renderer)` and
`python -m pathtracer_torch.app`.
"""
