"""Hopper probes: the port's counterparts of the Pallas probes under the
repo's ``tools/``, and the tools that read the card. Each probe module holds
a hand-written CUDA kernel's wrapper, its plain PyTorch version and a
``main()`` that asks the TPU probe's question on the card
(``python -m cuda_pathtracer_tpu_torch.tools.<module>``; with ``--device
cpu`` the plain versions run, and no time is printed).

The probe kernels live in ``tools/csrc/`` and build into their own library,
apart from the renderer's (``probe_kernels``: names, launch counters,
``library()``).

- ``gather_probe``: row and element gathers, dependent row reads by table size
  (``tools/csrc/probe_gather.cu``);
- ``bf16_probe``: a chained slab test in f32, bf16x2 and widened bf16
  (``tools/csrc/probe_slab.cu``);
- ``step_probe``: a scripted packet step chained T times, with toggles and
  interleaved chains (``tools/csrc/probe_step.cu``);
- ``onehot_probe``: per-lane row fetches by a one-hot tensor-core product or
  a load (``tools/csrc/probe_onehot.cu``);
- ``packet_step_probe``: the TPU packet-traversal step on one block, ns per
  packet-step (``tools/csrc/probe_packet_step.cu``);
- ``decision_probe``: the cost of a vector-to-scalar decision round trip
  (``tools/csrc/probe_decision.cu``);
- ``visit_probe``: the v2 packet visit taken apart piece by piece
  (``tools/csrc/probe_visit.cu``);
- ``lab_v1_probe``: the v1 packet walk and its ablations on sibenik's waves
  (``tools/csrc/probe_packet_walk.cu``);
- ``packet_ops``: the plain pieces of a 128-ray packet step that the last
  four share (their kernels share ``tools/csrc/probe_packet.cuh``);
- ``timing``: the card line, CUDA-event timing and the bound;
- ``idle_by_span``: the card's idle time in the Whitted still loop, split by
  the innermost span open on the host.
"""
