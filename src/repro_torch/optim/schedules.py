"""Learning-rate schedules (port of ``repro.optim.schedules``: the linear
warmup the training step uses)."""

from __future__ import annotations


def linear_warmup(step: int, base_lr: float, warmup_steps: int,
                  start_frac: float) -> float:
    """Linear warmup from start_frac·base_lr to base_lr (paper: 1/W → 1)."""
    frac = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
    return base_lr * (start_frac + (1.0 - start_frac) * frac)
