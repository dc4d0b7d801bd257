"""Step timing (counterpart of ``sdbc_tpu/utils/profiling.py``'s
``StepTimer``): the caller's per-step wall times → images/s per chip, the
warm-up steps left out.  The JAX package's ``jax.profiler`` helpers have
no counterpart here; the finetune CLI's ``--profile_dir`` takes a
``torch.profiler`` trace instead.
"""
from __future__ import annotations

from typing import List


class StepTimer:
    """Per-step wall times → images/sec/chip (skipping warm-up steps)."""

    def __init__(self, images_per_step: int, n_chips: int = 1, warmup: int = 1):
        self.images_per_step = images_per_step
        self.n_chips = max(n_chips, 1)
        self.warmup = warmup
        self.times: List[float] = []

    @property
    def steady_times(self) -> List[float]:
        return self.times[self.warmup:] if len(self.times) > self.warmup \
            else self.times

    def images_per_sec_per_chip(self) -> float:
        ts = self.steady_times
        if not ts:
            return 0.0
        return self.images_per_step / (sum(ts) / len(ts)) / self.n_chips
