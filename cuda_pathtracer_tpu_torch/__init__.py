"""cuda_pathtracer_tpu_torch — the PyTorch + CUDA port of cuda_pathtracer_tpu.

The JAX package beside it is the reference this port is tested against. The
port imports ``torch`` and never ``jax``; from the JAX package it reuses only
the numpy host modules (``accel/`` but ``refit.py``, ``core/transforms.py``,
``scene/objloader.py``, ``scene/procedural.py``, ``constants.py``). The three
kernels on the render path are hand-written CUDA under ``csrc/``, built with
``nvcc`` at first use (``ops/kernels.py``).
"""
