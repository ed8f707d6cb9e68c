"""Learning-rate schedules (port of ``repro.optim.schedules``: the linear
warmup the training step uses, and the paper's CIFAR-10 recipe with its
step decay).  Plain float functions of the step."""

from __future__ import annotations

from typing import Iterable


def linear_warmup(step: int, base_lr: float, warmup_steps: int,
                  start_frac: float) -> float:
    """Linear warmup from start_frac·base_lr to base_lr (paper: 1/W → 1)."""
    frac = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
    return base_lr * (start_frac + (1.0 - start_frac) * frac)


def step_decay(step: int, lr: float, milestones: Iterable[int],
               factor: float = 0.1) -> float:
    """Multiply by ``factor`` at each milestone reached (paper: /10 at
    epochs 150 and 250)."""
    for m in milestones:
        if step >= m:
            lr = lr * factor
    return lr


def paper_cifar_schedule(step: int, base_lr: float, num_workers: int,
                         steps_per_epoch: int) -> float:
    """The paper's CIFAR-10 recipe: a 5-epoch linear warmup from the
    single-worker rate to W times it, then /10 at epochs 150 and 250."""
    lr = linear_warmup(step, base_lr * num_workers, 5 * steps_per_epoch,
                       1.0 / num_workers)
    return step_decay(step, lr, (150 * steps_per_epoch, 250 * steps_per_epoch))
