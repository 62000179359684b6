"""The benchmark's plain reference: what ``correct`` is decided against.

Written from the renderer's published semantics (HugoPeters1024/
cuda_pathtracer, as the JAX package states them), in plain PyTorch, and
sharing no code with the port: its own scene container (``scenes.py``),
its own BVH, built by Morton order and walked per ray (``bvh.py``), and its
own Whitted tracer and display transform (``whitted.py``). Only the
stand-in geometry generator (``procedural.py``), which makes the input
data, is a frozen copy of the port's.
"""
