"""Plain SGD with momentum (the paper's full-precision baseline) and
Signum (Bernstein et al., 2019), sign-of-momentum with a majority vote,
which the paper benchmarks against (§5.2, Appendix G.5); port of
``repro.optim.sgd``.

Standalone optimizers, not error-feedback compressors.  Under a
:class:`~repro_torch.core.simmesh.SimMesh` context the gradients carry the
worker dim; SGD's momentum and the parameters are worker-identical and held
once, Signum's momentum is each worker's own and carries the worker dim.
Both return new tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree
from repro_torch.core.dist import SINGLE, MeshCtx


@dataclasses.dataclass
class SGDState:
    momentum: Any
    step: int = 0


def sgd_init(params) -> SGDState:
    return SGDState(momentum=tree.map(torch.zeros_like, params))


def sgd_apply(params, grads, state: SGDState, *, lr, momentum=0.9,
              weight_decay=0.0, ctx: MeshCtx = SINGLE):
    """Synchronous data-parallel SGD: the mean of the raw gradients (one
    ``pmean_data`` per leaf), then ``m ← λm + g``, ``x ← x − lr·m``."""
    grads = tree.map(ctx.pmean_data, grads)
    if weight_decay:
        grads = tree.map(lambda g, p: g + weight_decay * p, grads, params)
    new_m = tree.map(lambda m, g: momentum * m + g, state.momentum, grads)
    new_p = tree.map(lambda p, m: p - lr * m, params, new_m)
    return new_p, SGDState(momentum=new_m, step=state.step + 1)


@dataclasses.dataclass
class SignumState:
    momentum: Any    # each worker's own (ctx.lead worker dims)
    step: int = 0


def signum_init(params, lead=()) -> SignumState:
    """Zero momentum with ``lead`` worker dims."""
    return SignumState(momentum=tree.map(
        lambda p: p.new_zeros(tuple(lead) + tuple(p.shape)), params))


def signum_apply(params, grads, state: SignumState, *, lr, momentum=0.9,
                 ctx: MeshCtx = SINGLE):
    """Signum: per-worker momentum ``m ← λm + (1−λ)g``, its signs summed
    over the workers (one ``psum_data`` per leaf: the majority vote), and
    ``x ← x − lr·sign(votes)``."""
    new_m = tree.map(lambda m, g: momentum * m + (1 - momentum) * g,
                     state.momentum, grads)
    votes = tree.map(lambda m: ctx.psum_data(torch.sign(m)), new_m)
    new_p = tree.map(lambda p, v: p - lr * torch.sign(v), params, votes)
    return new_p, SignumState(momentum=new_m, step=state.step + 1)
