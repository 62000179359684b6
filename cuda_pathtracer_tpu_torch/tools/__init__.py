"""Hopper probes: the port's counterparts of the Pallas probes under the
repo's ``tools/``. Each module holds a hand-written CUDA kernel's wrapper, its
plain PyTorch version and a ``main()`` that asks the TPU probe's question on
the card (``python -m cuda_pathtracer_tpu_torch.tools.<module>``; with
``--device cpu`` the plain versions run, and no time is printed).

- ``gather_probe``: row and element gathers, dependent row reads by table size
  (``csrc/probe_gather.cu``);
- ``bf16_probe``: a chained slab test in f32, bf16x2 and widened bf16
  (``csrc/probe_slab.cu``);
- ``step_probe``: a scripted packet step chained T times, with toggles and
  interleaved chains (``csrc/probe_step.cu``);
- ``onehot_probe``: per-lane row fetches by a one-hot tensor-core product or
  a load (``csrc/probe_onehot.cu``);
- ``timing``: the card line, CUDA-event timing and the bound.
"""
