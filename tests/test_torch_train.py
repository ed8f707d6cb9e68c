"""The slice end to end: 5 steps of the port's ``make_sim_train_step``
against ``repro.launch.train.make_sim_train_step`` on reduced Llama-3-8B
with a 4-worker SimMesh, from the same parameters and Q factors (carried
over by ``repro_torch.bridge``) on the same ``MarkovLM`` batches.

Tolerances: per-step lm_loss rtol 1e-5, final params atol 2e-6 (fp32 with
different reduction orders; measured: params within 3.1e-7, losses within
1.3e-7 relative)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jllama
from repro.core.simmesh import SimMesh as JSimMesh
from repro.launch import train as jtrain
from repro_torch import bridge, tree
from repro_torch.configs import llama3_8b
from repro_torch.core.dist import CollectiveStats
from repro_torch.core.error_feedback import EFState
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.kernels import lowrank
from repro_torch.launch import train


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


W, STEPS, BATCH, SEQ = 4, 5, 8, 32


def _batches(vocab, steps=STEPS):
    data = MarkovLM(vocab=vocab, seed=0, order=1)
    for i in range(steps):
        toks = data.sample(BATCH, SEQ, step=i)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def _reference_run(steps, **kw):
    """``steps`` steps of the reference's simulated step; returns (start
    params and Q, per-step losses, final params) as numpy."""
    cfg = jllama.reduced_config()
    sim = JSimMesh(W)
    hyper = jtrain.TrainHyper(remat=False, q_chunk=16, warmup_steps=2, **kw)
    step, init = jtrain.make_sim_train_step(cfg, sim, hyper)
    params, ef = init(jax.random.key(0))
    first = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x[0]), t,
        is_leaf=lambda x: x is None)
    start = (first(params), first(ef.comp))
    losses = []
    for i, b in enumerate(_batches(cfg.vocab_size, steps)):
        params, ef, m = step(params, ef, sim.shard(b), jax.random.key(i))
        losses.append(float(m["lm_loss"][0]))
    return start, losses, first(params)


def _port_run(start, steps, stats, **kw):
    """The port's simulated step from the reference's start; returns
    (losses, final params, EF state)."""
    params0, q0 = start
    cfg = llama3_8b.reduced_config()
    sim = SimMesh(W)
    step, _ = train.make_sim_train_step(
        cfg, sim, train.TrainHyper(q_chunk=16, warmup_steps=2, **kw),
        stats=stats, device="cpu")
    params = bridge.to_torch(params0)
    ef = EFState(error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
                 momentum=tree.map(torch.zeros_like, params),
                 comp=bridge.to_torch(q0))
    losses = []
    for b in _batches(cfg.vocab_size, steps):
        params, ef, m = step(params, ef, sim.shard(
            {k: torch.tensor(v) for k, v in b.items()}))
        losses.append(m["lm_loss"].item())
    return losses, params, ef


def _hold(losses, params, ref_losses, ref_params):
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for (path, got), want in zip(tree.items(bridge.to_numpy(params)),
                                 tree.leaves(ref_params)):
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0, err_msg=str(path))


@pytest.fixture(scope="module")
def reference():
    return _reference_run(STEPS)


def test_five_steps_match_reference(reference):
    start, ref_losses, ref_params = reference
    stats = CollectiveStats()
    lowrank.reset_launches()
    losses, params, ef = _port_run(start, STEPS, stats)
    _hold(losses, params, ref_losses, ref_params)
    assert ef.step == STEPS
    # 2 fused reduces per step; the CPU path never launches a CUDA kernel
    assert stats.reduce_collectives == 2 * STEPS
    assert lowrank.LAUNCHES == {"lowrank_project": 0, "lowrank_backproject": 0}


def test_cholesky_qr_steps_match_reference():
    """3 steps under ``TrainHyper(orthogonalizer="cholesky_qr")`` against
    the reference's, at the same tolerances (its P slabs are well
    conditioned)."""
    start, ref_losses, ref_params = _reference_run(
        3, orthogonalizer="cholesky_qr")
    stats = CollectiveStats()
    losses, params, ef = _port_run(start, 3, stats,
                                   orthogonalizer="cholesky_qr")
    _hold(losses, params, ref_losses, ref_params)
    assert ef.step == 3 and stats.reduce_collectives == 2 * 3


def test_init_state_layout():
    cfg = llama3_8b.reduced_config()
    step, init = train.make_sim_train_step(cfg, SimMesh(3), train.TrainHyper(),
                                           device="cpu")
    params, ef = init(torch.Generator().manual_seed(0))
    for p, e, m in zip(tree.leaves(params), tree.leaves(ef.error),
                       tree.leaves(ef.momentum)):
        assert tuple(e.shape) == (3,) + tuple(p.shape) and not e.any()
        assert tuple(m.shape) == tuple(p.shape) and not m.any()
    qs = {path: q for path, q in tree.items(ef.comp)}
    assert qs[("final_norm",)] is None
    assert tuple(qs[("head",)].shape) == (cfg.vocab_size, 2)
    assert tuple(qs[("blocks", "slot0", "mixer", "wq")].shape) == (2, 256, 2)


def test_entry_point_defaults_to_cuda():
    """Without ``device=`` the step runs on the card, and raises where there
    is none — nothing silently moves to the CPU."""
    cfg = llama3_8b.reduced_config()
    if torch.cuda.is_available():
        assert train.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.make_sim_train_step(cfg, SimMesh(2), train.TrainHyper())
    with pytest.raises(RuntimeError):
        train.resolve_device("cuda:0")
    assert train.resolve_device("cpu").type == "cpu"


def test_linear_warmup_matches_reference():
    hyper = train.TrainHyper(warmup_steps=10)
    jhyper = jtrain.TrainHyper(warmup_steps=10)
    for s in (0, 3, 10, 50):
        np.testing.assert_allclose(train._schedule(hyper, s),
                                   float(jtrain._schedule(jhyper, s)), rtol=1e-6)
