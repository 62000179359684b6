"""Rendering over several ranks (counterpart of
``cuda_pathtracer_tpu/parallel/``): :mod:`.mesh`."""
