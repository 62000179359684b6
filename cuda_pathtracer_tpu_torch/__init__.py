"""cuda_pathtracer_tpu_torch — the PyTorch + CUDA port of cuda_pathtracer_tpu.

The JAX package beside it is the reference this port is tested against. The
port imports ``torch`` and numpy, never ``jax``, and nothing of
``cuda_pathtracer_tpu``: it keeps its own copies of the numpy host modules it
needs (``constants.py``, ``accel/``, ``core/transforms.py``,
``scene/objloader.py``, ``scene/procedural.py``). The four kernels of the
render path are hand-written CUDA under ``csrc/``, built with ``nvcc`` at
first use (``ops/kernels.py``), as are the four probe kernels of ``tools/``.
``python -m cuda_pathtracer_tpu_torch`` is the headless CLI.
"""
