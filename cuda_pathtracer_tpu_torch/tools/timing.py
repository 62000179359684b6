"""Timing on the card: the card line, CUDA-event times behind a sleep
pre-roll, and the least time the card could take for a piece of work.

Every time here is taken on a CUDA device; nothing falls back to a host
clock, and nothing here runs without a card but :func:`bound`.
"""
from __future__ import annotations

import subprocess

# the card's peaks (NVIDIA H100 SXM data sheet; the bf16 rate outside the
# tensor cores from the H100 architecture white paper)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 134e12          # packed bf16x2 on the CUDA cores
TENSOR_BF16_OPS_PER_S = 989e12   # dense bf16 on the tensor cores
PREROLL_CYCLES = 20_000_000      # ~10 ms of sleep kernel at the H100's clock


def card_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi prints them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def require_card():
    """Raise unless a CUDA device is there: a measurement never falls back."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: card measurements need one')


def cuda_ms(fn, reps: int = 1, warmup: int = 0, preroll: bool = False):
    """Mean milliseconds of fn() over reps, from CUDA events, and fn's last
    result. With ``preroll`` a sleep kernel runs first, so the host has
    queued every call before the first one starts: the device's time, not
    the host's time per call (the way to time one kernel whose launches are
    shorter than their wrapper)."""
    import torch
    for _ in range(warmup):
        fn()
    if preroll:
        torch.cuda._sleep(PREROLL_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(bound_ms, bound_by): the least time for the work on this card, the
    larger of its bytes over the memory rate and its operations over the
    rate of their type (FP32 unless given)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')
