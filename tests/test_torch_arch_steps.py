"""3 EF-PowerSGD steps of the port's ``make_sim_train_step`` against
``repro.launch.train.make_sim_train_step`` at W = 2, on reduced
Qwen3-30B-A3B (MoE, qk-norm), Mamba2-1.3B and Jamba (the hybrid: Mamba-2,
attention, MoE and dense slots), from the same parameters and Q factors
(the port's draw, carried over as numpy arrays by ``repro_torch.bridge``)
on the same ``MarkovLM`` batches.  The expert weights are compressor batch
entries (``MatrixSpec("matrix", 1)``, two batch dims after stacking), so
the bucketed engine meets slabs of every new shape.

Tolerances: per-step ``lm_loss`` and ``moe_aux`` rtol 1e-5 (those of
``tests/test_torch_train.py``); parameters after 3 steps within
``PARAM_ATOL``, per architecture: Qwen3-30B-A3B 1e-5 (measured 1.2e-7),
Jamba 5e-5 (measured 2.6e-6, the embedding) and Mamba2-1.3B 5e-3
(measured 3.5e-5, the embedding; 1.2e-3 from the reference's own draw).
The last is the trajectory's own sensitivity, not a difference of the
models: in the port alone, a relative perturbation of 1e-7 of the
initial parameters moves the embedding 5.2e-5 after the same 3 steps
(4.9e-4 from the reference's draw: each step's rank-2 P of the
embedding's gradient amplifies the gap; ``python
tests/test_torch_arch_steps.py --sensitivity`` measures it).  The MoE
combine and the SSD scan sum in other orders than the reference's
(ROADMAP C6).  The step makes its two fused reduces each step.
``python tests/test_torch_arch_steps.py`` prints the gaps.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core.error_feedback import EFState as JEFState
from repro.core.simmesh import SimMesh as JSimMesh
from repro.launch import train as jtrain
from repro_torch import bridge, tree
from repro_torch.configs import base
from repro_torch.core.dist import CollectiveStats
from repro_torch.core.error_feedback import EFState
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import train


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


W, STEPS, BATCH, SEQ = 2, 3, 4, 33
LOSS_RTOL = 1e-5
PARAM_ATOL = {"qwen3_moe_30b_a3b": 1e-5, "jamba_v01_52b": 5e-5,
              "mamba2_1p3b": 5e-3}
ARCHS = ("qwen3_moe_30b_a3b", "mamba2_1p3b", "jamba_v01_52b")
HYPER = {"q_chunk": 16, "warmup_steps": 2}


def _batches(vocab):
    data = MarkovLM(vocab=vocab, seed=0, order=1)
    for i in range(STEPS):
        toks = data.sample(BATCH, SEQ, step=i)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def _start(arch):
    """The initial parameters and Q factors as numpy arrays: the port's
    draw (the reference's own draw runs op by op and takes seconds a
    model)."""
    _, init = train.make_sim_train_step(base.get_config(arch, True), SimMesh(W),
                                        train.TrainHyper(**HYPER), device="cpu")
    params, ef = init(torch.Generator().manual_seed(0))
    return bridge.to_numpy(params), bridge.to_numpy(ef.comp)


def _reference_run(arch, start=None):
    """The reference's STEPS steps from ``start`` (default :func:`_start`),
    its state built as its ``init_state`` builds it."""
    cfg = jbase.get_config(arch, True)
    sim = JSimMesh(W)
    step, _ = jtrain.make_sim_train_step(
        cfg, sim, jtrain.TrainHyper(remat=False, **HYPER))
    start = _start(arch) if start is None else start
    params = jax.tree_util.tree_map(jnp.asarray, start[0])
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    ef = JEFState(error=zeros(params), momentum=zeros(params),
                  comp=jax.tree_util.tree_map(jnp.asarray, start[1]),
                  step=jnp.zeros((), jnp.int32), inflight=None)
    params, ef = sim.replicate(params), sim.replicate(ef)
    first = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else np.array(x[0]), t,
        is_leaf=lambda x: x is None)
    metrics = []
    for i, b in enumerate(_batches(cfg.vocab_size)):
        params, ef, m = step(params, ef, sim.shard(b), jax.random.key(i))
        metrics.append((float(m["lm_loss"][0]), float(m["moe_aux"][0])))
    return start, metrics, first(params)


def _port_run(arch, start, stats):
    cfg = base.get_config(arch, True)
    sim = SimMesh(W)
    step, _ = train.make_sim_train_step(cfg, sim, train.TrainHyper(**HYPER),
                                        stats=stats, device="cpu")
    params = bridge.to_torch(start[0])
    ef = EFState(error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(start[1]))
    metrics = []
    for b in _batches(cfg.vocab_size):
        params, ef, m = step(params, ef, sim.shard(
            {k: torch.tensor(v) for k, v in b.items()}))
        metrics.append((m["lm_loss"].item(), m["moe_aux"].item()))
    return metrics, params


def _gaps(arch):
    start, ref_metrics, ref_params = _reference_run(arch)
    stats = CollectiveStats()
    metrics, params = _port_run(arch, start, stats)
    gaps = {path: float(np.abs(got - want).max())
            for (path, got), want in zip(tree.items(bridge.to_numpy(params)),
                                         tree.leaves(ref_params))}
    return metrics, ref_metrics, gaps, stats


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_reference(arch):
    metrics, ref_metrics, gaps, stats = _gaps(arch)
    np.testing.assert_allclose(metrics, ref_metrics, rtol=LOSS_RTOL, atol=1e-7)
    assert all(np.isfinite(metrics).ravel())
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= PARAM_ATOL[arch], (worst, gaps[worst])
    assert stats.reduce_collectives == 2 * STEPS


def _sensitivity(arch, rel=1e-7):
    """The port's largest parameter gap after STEPS steps between the
    reference's start and that start perturbed by ``rel`` relative."""
    start = _start(arch)
    r = np.random.default_rng(0)
    moved = jax.tree_util.tree_map(
        lambda x: (x * (1 + rel * r.standard_normal(x.shape))).astype(np.float32),
        start[0])
    a = _port_run(arch, start, CollectiveStats())[1]
    b = _port_run(arch, (moved, start[1]), CollectiveStats())[1]
    return max(float((x - y).abs().max())
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


if __name__ == "__main__":
    if "--sensitivity" in sys.argv:
        for arch in ARCHS:
            print(arch, "port against its perturbed start:", _sensitivity(arch))
        sys.exit(0)
    for arch in ARCHS:
        metrics, ref_metrics, gaps, _ = _gaps(arch)
        worst = max(gaps, key=gaps.get)
        print(arch, "metrics", metrics, ref_metrics, "worst param gap",
              worst, gaps[worst])
    sys.exit(0)
