"""The port's LSTM language model (``repro_torch.models.lstm``) against the
JAX package's ``repro.models.lstm``, on the same numpy parameters and
tokens (carried over by ``repro_torch.bridge``).  Table 7's driver is held
in ``tests/test_torch_tables.py``.

* Init: the same tree of shapes; at the paper's width 28,941,519
  parameters, the reference's rank-1 compressed-float total (Table 11:
  ratio in 280–340) and the encoder's 636× (Table 11).
* At vocab 32, embedding = hidden = 16, 2 layers, 8 tokens: logits, loss
  and every gradient within atol 1e-6 / rtol 1e-4 (float32 with different
  summation orders; measured 1.5e-8 in logits, 7.5e-9 in gradients).
* Three EF-PowerSGD steps (rank 2, lr 0.8, momentum 0.9) from the
  reference's parameters and Q factors, at W = 1 on the single-device
  context (Table 7's path) and at W = 2 on ``SimMesh`` against the
  reference's ``SimMesh.run`` step: losses within rtol 1e-5, parameters
  within atol 2e-6 (measured: W = 1 1.4e-7 relative in loss and 6.0e-8 in
  parameters of magnitude up to 0.98; W = 2 losses equal, 3.0e-8).
* The twin of ``tests/test_system.py::test_resnet_and_lstm_train``: the loss
  falls by 0.3 over 100 steps.
"""

import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import error_feedback as jef
from repro.core import matrixize as jmz
from repro.core import powersgd as jpsgd
from repro.core.simmesh import SimMesh as JSimMesh
from repro.models import lstm as jlstm
from repro_torch import bridge, tree
from repro_torch.core import error_feedback, matrixize, powersgd
from repro_torch.core.compressors import make_compressor
from repro_torch.core.dist import SINGLE
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch.train import grad_with_aux
from repro_torch.models import lstm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KEY = jax.random.key(0)
SMALL = dict(vocab=32, embed=16, hidden=16, layers=2, init_scale=0.15)
STEPS, RANK, LR, SEQ = 3, 2, 0.8, 8


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _assert_trees_close(got, want, atol, rtol=0.0):
    got, want = list(tree.items(got)), list(tree.items(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=str(path))


@pytest.mark.parametrize("cfg_kw", [SMALL, {}], ids=["small", "paper"])
def test_init_shapes_equal_reference(cfg_kw):
    jparams = jax.eval_shape(lambda: jlstm.init(KEY, jlstm.LSTMConfig(**cfg_kw)))
    params = lstm.init(lstm.LSTMConfig(**cfg_kw), None, device="meta")
    assert ([(p, tuple(x.shape)) for p, x in tree.items(params)]
            == [(p, x.shape) for p, x in tree.items(jparams)])
    specs, jspecs = lstm.mspecs(params), jlstm.mspecs(jparams)
    assert ([(s.kind, s.batch_dims) for s in tree.leaves(specs)]
            == [(s.kind, s.batch_dims) for s in tree.leaves(jspecs)])


def test_lstm_total_compression_matches_paper():
    """Paper Table 11: the whole LSTM compresses 310/r×."""
    params = lstm.init(lstm.paper_lstm(), None, device="meta")
    specs = lstm.mspecs(params)
    total = sum(p.numel() for p in tree.leaves(params))
    sent = powersgd.compressed_floats_total(params, specs, rank=1)
    jparams = jax.eval_shape(lambda: jlstm.init(KEY, jlstm.paper_lstm()))
    assert total == 28_941_519
    assert sent == jpsgd.compressed_floats_total(jparams, jlstm.mspecs(jparams),
                                                 rank=1)
    assert 280 < total / sent < 340


def test_lstm_encoder_matches_paper_table11():
    """The encoder (28869, 650) compresses 636/r×."""
    shape, spec = (28869, 650), matrixize.MatrixSpec("matrix", 0)
    ratio = math.prod(shape) / matrixize.compressed_floats(shape, spec, 1)
    assert abs(ratio - 636) < 1.0
    assert matrixize.compressed_floats(shape, spec, 1) == jmz.compressed_floats(
        shape, jmz.MatrixSpec("matrix", 0), 1)


def _tokens(vocab, batch, step, seed=0):
    toks = MarkovLM(vocab=vocab, seed=seed, order=1).sample(batch, SEQ, step)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@pytest.fixture(scope="module")
def small():
    cfg = jlstm.LSTMConfig(**SMALL)
    return cfg, jax.jit(jlstm.init, static_argnums=1)(KEY, cfg)


def test_forward_loss_and_grads_match_reference(small):
    jcfg, jparams = small
    cfg = lstm.LSTMConfig(**SMALL)
    batch = _tokens(cfg.vocab, 3, 0, seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits, (want_grads, want_met) = jax.jit(lambda p, b: (
        jlstm.forward(p, b["tokens"], jcfg),
        jax.grad(jlstm.loss_fn, has_aux=True)(p, b, jcfg)))(jparams, jbatch)

    params, tbatch = bridge.to_torch(_np(jparams)), bridge.to_torch(batch)
    logits = lstm.forward(params, tbatch["tokens"], cfg)
    grads, met = grad_with_aux(lstm.loss_fn)(params, tbatch, cfg)
    assert tuple(logits.shape) == (3, SEQ, cfg.vocab)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               atol=1e-6, rtol=1e-4)
    for k in ("loss", "ppl"):
        np.testing.assert_allclose(met[k].item(), float(want_met[k]), rtol=1e-5)
    _assert_trees_close(bridge.to_numpy(grads), _np(want_grads), atol=1e-6,
                        rtol=1e-4)


def _reference_steps(jcfg, params, workers):
    """Three reference EF-PowerSGD steps: ``apply_updates`` on the
    single-device context at W = 1 (as Table 7 trains), ``SimMesh.run`` at
    W > 1.  Returns the start, the losses and the final parameters."""
    comp = jcomp.PowerSGDCompressor(rank=RANK)
    specs = jlstm.mspecs(params)
    ef = jax.jit(lambda p: jef.init_state(comp, p, specs, KEY))(params)
    start = (_np(params), _np(ef.comp))
    grad = jax.grad(jlstm.loss_fn, has_aux=True)

    if workers == 1:
        @jax.jit
        def step(params, ef, batch):
            grads, met = grad(params, batch, jcfg)
            params, ef, _ = jef.apply_updates(comp, params, grads, ef, specs, lr=LR,
                                              momentum=0.9, key=KEY)
            return params, ef, met["loss"]
    else:
        sim = JSimMesh(workers)

        def worker(params, ef, batch):
            ctx = sim.ctx()
            grads, met = grad(params, batch, jcfg)
            params, ef, _ = jef.apply_updates(comp, params, grads, ef, specs, lr=LR,
                                              momentum=0.9, ctx=ctx, key=KEY)
            return params, ef, ctx.backend.pmean(met["loss"], ctx.data_axes)

        mapped = jax.jit(sim.run(worker))
        params, ef = sim.replicate(params), sim.replicate(ef)

        def step(params, ef, batch):
            params, ef, loss = mapped(params, ef, sim.shard(batch))
            return params, ef, loss[0]

    losses = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in _tokens(jcfg.vocab, 4, i).items()}
        params, ef, loss = step(params, ef, batch)
        losses.append(float(loss))
    if workers > 1:
        params = jax.tree_util.tree_map(lambda x: x[0], params)
    return start, losses, _np(params)


def _port_steps(params0, q0, workers):
    cfg = lstm.LSTMConfig(**SMALL)
    comp = make_compressor("powersgd", rank=RANK)
    params = bridge.to_torch(params0)
    specs = lstm.mspecs(params)
    lead = () if workers == 1 else (workers,)
    ef = error_feedback.EFState(
        error=tree.map(lambda p: torch.zeros(lead + tuple(p.shape)), params),
        momentum=tree.map(torch.zeros_like, params), comp=bridge.to_torch(q0))
    grad = grad_with_aux(lstm.loss_fn)
    if workers == 1:
        ctx = SINGLE
    else:
        sim = SimMesh(workers)
        ctx, grad = sim.ctx(), sim.run(grad, in_axes=(None, 0, None))
    losses = []
    for i in range(STEPS):
        batch = bridge.to_torch(_tokens(cfg.vocab, 4, i))
        if workers > 1:
            batch = sim.shard(batch)
        grads, met = grad(params, batch, cfg)
        params, ef, _ = error_feedback.apply_updates(comp, params, grads, ef, specs,
                                                     lr=LR, momentum=0.9, ctx=ctx)
        losses.append(met["loss"].mean().item())
    assert ef.step == STEPS
    return losses, bridge.to_numpy(params)


@pytest.mark.parametrize("workers", [1, 2])
def test_three_powersgd_steps_match_reference(small, workers):
    jcfg, jparams = small
    (params0, q0), want_losses, want_params = _reference_steps(jcfg, jparams, workers)
    losses, params = _port_steps(params0, q0, workers)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_trees_close(params, want_params, atol=2e-6)


def test_lstm_trains():
    """The loss falls by 0.3 over 100 EF-PowerSGD steps on the order-1
    Markov stream (the twin of the reference's system test)."""
    cfg = lstm.LSTMConfig(vocab=32, embed=64, hidden=64, layers=2, init_scale=0.15)
    gen = torch.Generator().manual_seed(0)
    params = lstm.init(cfg, gen, device="cpu")
    specs = lstm.mspecs(params)
    comp = make_compressor("powersgd", rank=2)
    ef = error_feedback.init_state(comp, params, specs, generator=gen)
    it = MarkovLM(vocab=32, seed=1, order=1).batches(16, 32)
    grad = grad_with_aux(lstm.loss_fn)
    losses = []
    for _ in range(100):
        grads, met = grad(params, bridge.to_torch(next(it)), cfg)
        params, ef, _ = error_feedback.apply_updates(comp, params, grads, ef, specs,
                                                     lr=0.8, momentum=0.9)
        losses.append(met["loss"].item())
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


if __name__ == "__main__":
    # The measured gaps behind the tolerances above, and the one-ulp spread
    # behind chip_smoke.py's rule for the LSTM (its card-against-CPU run
    # at the paper's width, on the CPU)
    import types

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.bench import common as bench
    from repro_torch.core import compressors
    from repro_torch.data.synthetic import GaussianClusters
    from repro_torch.launch import train
    from repro_torch.models import resnet
    from repro_torch.optim import schedules

    gap = lambda got, want: max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
                                for (_, g), (_, w) in zip(tree.items(got),
                                                          tree.items(want)))
    jcfg = jlstm.LSTMConfig(**SMALL)
    jparams = jax.jit(jlstm.init, static_argnums=1)(KEY, jcfg)
    cfg = lstm.LSTMConfig(**SMALL)
    batch = _tokens(cfg.vocab, 3, 0, seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits, (want_grads, _) = jax.jit(lambda p, b: (
        jlstm.forward(p, b["tokens"], jcfg),
        jax.grad(jlstm.loss_fn, has_aux=True)(p, b, jcfg)))(jparams, jbatch)
    params = bridge.to_torch(_np(jparams))
    logits = lstm.forward(params, bridge.to_torch(batch)["tokens"], cfg)
    grads, _ = grad_with_aux(lstm.loss_fn)(params, bridge.to_torch(batch), cfg)
    print("logits gap", float(np.abs(logits.detach().numpy() - want_logits).max()),
          "gradients gap", gap(bridge.to_numpy(grads), _np(want_grads)))
    for workers in (1, 2):
        (p0, q0), want_l, want_p = _reference_steps(jcfg, jparams, workers)
        losses, got_p = _port_steps(p0, q0, workers)
        print(f"three steps at W = {workers}: loss relative gap",
              max(abs(a - b) / abs(b) for a, b in zip(losses, want_l)),
              "parameters", gap(got_p, want_p),
              "largest parameter", max(float(np.abs(x).max())
                                       for _, x in tree.items(want_p)))

    pm = types.SimpleNamespace(
        resnet=resnet, lstm=lstm, SimMesh=SimMesh, GaussianClusters=GaussianClusters,
        MarkovLM=MarkovLM, compressors=compressors, error_feedback=error_feedback,
        schedules=schedules, train=train, tree=tree, bench=bench)
    ends = []
    for nudge in (False, True):
        tr = chip_smoke.PaperTrainer(torch, pm, "lstm", chip_smoke.PAPER_CPU_WORKERS,
                                     "cpu")
        st = tr.init()
        if nudge:
            st["params"] = tree.map(
                lambda x: torch.nextafter(x, torch.full_like(x, math.inf)),
                st["params"])
        per = chip_smoke.PAPER["lstm"][2] // chip_smoke.PAPER_CPU_WORKERS
        ls = [tr.step(st, b).item()
              for b in tr.batches(per, chip_smoke.PAPER_CPU_STEPS)]
        ends.append((ls, bridge.to_numpy(st["params"])))
    (la, pa), (lb, pb) = ends
    print(f"chip_smoke's LSTM comparison on the CPU: one ulp moves the parameters "
          f"by {gap(pa, pb):.2e}, the losses by "
          f"{max(abs(a - b) / abs(a) for a, b in zip(la, lb)):.2e} relative")
