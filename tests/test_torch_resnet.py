"""The port's CIFAR ResNet (``repro_torch.models.resnet``) against the JAX
package's ``repro.models.resnet``, on the same numpy parameters and images
(carried over by ``repro_torch.bridge``).

* Init: the same tree of shapes; at the paper's width 11,173,962
  parameters and the same rank-1 compressed-float total (Table 10: ratio
  in 220–260).
* ``_same_pads`` equals XLA's ``"SAME"`` padding, and at width 8, blocks
  (1, 1), 4 classes, image sizes 8 (stride-2 pads (0, 1)) and 7 (pads
  (1, 1)), ``train=True`` and ``train=False``: logits, new BN state, loss
  and every gradient agree within atol 2e-6 / rtol 1e-4 (float32 with
  different summation orders; measured up to 3.9e-7).
* Three EF-PowerSGD steps (rank 2, momentum 0.9, weight decay 1e-4, the
  paper's CIFAR-10 schedule) at W = 2 against the reference's
  ``SimMesh.run`` step from the reference's parameters and Q factors:
  losses within rtol 1e-5, parameters and BN state within atol 2e-6
  (measured: 1.2e-7 in parameters of magnitude up to 2.0, 2.4e-7 in BN
  state, 9.0e-8 relative in loss).
* The twin of ``tests/test_system.py::test_resnet_and_lstm_train``: 25 steps
  raise the accuracy by 0.2.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import compressors as jcomp
from repro.core import error_feedback as jef
from repro.core import powersgd as jpsgd
from repro.core.simmesh import SimMesh as JSimMesh
from repro.models import resnet as jresnet
from repro.optim import schedules as jsched
from repro_torch import bridge, tree
from repro_torch.core import error_feedback, powersgd
from repro_torch.core.compressors import make_compressor
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import GaussianClusters
from repro_torch.launch.train import grad_with_aux
from repro_torch.models import resnet
from repro_torch.optim import schedules


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KEY = jax.random.key(0)
SMALL = dict(width=8, blocks=(1, 1), num_classes=4)
W, STEPS, RANK, WD, PER_EPOCH = 2, 3, 2, 1e-4, 2


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _flat(t):
    """``(path, array)`` pairs of a numpy tree, in sorted-key order."""
    return list(tree.items(t))


def _assert_trees_close(got, want, atol, rtol=0.0):
    got, want = _flat(got), _flat(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=str(path))


@pytest.mark.parametrize("cfg_kw", [SMALL, {}], ids=["small", "paper"])
def test_init_shapes_equal_reference(cfg_kw):
    jparams, jstate = jax.eval_shape(
        lambda: jresnet.init(KEY, jresnet.ResNetConfig(**cfg_kw)))
    params, state = resnet.init(resnet.ResNetConfig(**cfg_kw), None, device="meta")
    for got, want in ((params, jparams), (state, jstate)):
        assert ([(p, tuple(x.shape)) for p, x in tree.items(got)]
                == [(p, x.shape) for p, x in tree.items(want)])
    specs, jspecs = resnet.mspecs(params), jresnet.mspecs(jparams)
    assert ([(s.kind, s.batch_dims) for s in tree.leaves(specs)]
            == [(s.kind, s.batch_dims) for s in tree.leaves(jspecs)])


def test_resnet18_total_compression_matches_paper():
    """Paper Table 10: the whole ResNet-18 compresses 243/r×."""
    params, _ = resnet.init(resnet.paper_resnet18(), None, device="meta")
    specs = resnet.mspecs(params)
    total = sum(p.numel() for p in tree.leaves(params))
    sent = powersgd.compressed_floats_total(params, specs, rank=1)
    jparams, _ = jax.eval_shape(lambda: jresnet.init(KEY, jresnet.paper_resnet18()))
    assert total == 11_173_962
    assert sent == jpsgd.compressed_floats_total(jparams, jresnet.mspecs(jparams),
                                                 rank=1)
    assert 220 < total / sent < 260


@pytest.mark.parametrize("n,k,s", [(8, 3, 2), (7, 3, 2), (32, 3, 2), (8, 1, 2),
                                   (7, 1, 2), (8, 3, 1), (5, 3, 1), (4, 1, 1),
                                   (9, 3, 3)])
def test_same_pads_equal_xla(n, k, s):
    assert resnet._same_pads(n, k, s) == tuple(
        lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


def _small():
    cfg = jresnet.ResNetConfig(**SMALL)
    params, state = jax.jit(jresnet.init, static_argnums=1)(KEY, cfg)
    # logits, new BN state and gradients in one compiled function
    both = jax.jit(lambda p, s, b, train: (
        jresnet.forward(p, s, b["images"], cfg, train),
        jax.grad(jresnet.loss_fn, has_aux=True)(p, s, b, cfg, train)),
        static_argnums=3)
    return cfg, params, state, both


@pytest.fixture(scope="module")
def small():
    return _small()


def _forward_case(small, size, train):
    """The port's and the reference's logits, new BN state (twice: from the
    forward and from the gradient's aux), loss, accuracy and gradients, as
    numpy trees ``(got, want)``."""
    jcfg, jparams, jstate, both = small
    cfg = resnet.ResNetConfig(**SMALL)
    rng = np.random.default_rng(size)
    batch = {"images": rng.standard_normal((6, size, size, 3)).astype(np.float32),
             "labels": rng.integers(0, 4, 6).astype(np.int32)}
    if not train:   # a carried state that is not the initial one
        jstate = jax.tree_util.tree_map(
            lambda x: x + jnp.asarray(rng.uniform(0.1, 0.5, x.shape), jnp.float32),
            jstate)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (logits, state), (grads, (state2, met)) = both(jparams, jstate, jbatch, train)
    want = {"logits": logits, "state": state, "state2": state2, "grads": grads,
            "loss": met["loss"], "acc": met["acc"]}

    params, state = bridge.to_torch(_np(jparams)), bridge.to_torch(_np(jstate))
    tbatch = bridge.to_torch(batch)
    logits, new_state = resnet.forward(params, state, tbatch["images"], cfg, train)
    grads, (state2, met) = grad_with_aux(resnet.loss_fn)(params, state, tbatch,
                                                         cfg, train)
    if not train:   # the carried state comes back unchanged
        _assert_trees_close(bridge.to_numpy(new_state), bridge.to_numpy(state),
                            atol=0.0)
    got = {"logits": logits.detach(), "state": new_state, "state2": state2,
           "grads": grads, "loss": met["loss"], "acc": met["acc"]}
    return bridge.to_numpy(got), _np(want)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("size", [8, 7])
def test_forward_loss_and_grads_match_reference(small, size, train):
    got, want = _forward_case(small, size, train)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(got.pop(k), want.pop(k), rtol=1e-5)
    _assert_trees_close(got, want, atol=2e-6, rtol=1e-4)


def _batches(image_size, classes, batch):
    data = GaussianClusters(num_classes=classes, image_size=image_size, noise=0.5)
    return [data.sample(batch, i) for i in range(STEPS)]


def _reference_steps(small):
    """Three W = 2 EF-PowerSGD steps of the reference: ``SimMesh.run`` over
    the gradient and ``apply_updates`` under the simulated context."""
    jcfg, params, bn, _ = small
    sim = JSimMesh(W)
    comp = jcomp.PowerSGDCompressor(rank=RANK)
    specs = jresnet.mspecs(params)
    ef = jax.jit(lambda p: jef.init_state(comp, p, specs, KEY))(params)
    start = (_np(params), _np(bn), _np(ef.comp))

    def worker(params, bn, ef, batch, lr):
        ctx = sim.ctx()
        grads, (bn, met) = jax.grad(jresnet.loss_fn, has_aux=True)(
            params, bn, batch, jcfg)
        params, ef, _ = jef.apply_updates(comp, params, grads, ef, specs, lr=lr,
                                          momentum=0.9, weight_decay=WD, ctx=ctx,
                                          key=KEY)
        return params, bn, ef, ctx.backend.pmean(met["loss"], ctx.data_axes)

    step = jax.jit(sim.run(worker, in_axes=(0, 0, 0, 0, None)))
    params, bn, ef = sim.replicate(params), sim.replicate(bn), sim.replicate(ef)
    losses = []
    for i, b in enumerate(_batches(8, 4, 8)):
        lr = jsched.paper_cifar_schedule(i, 0.1, W, PER_EPOCH)
        params, bn, ef, loss = step(params, bn, ef, sim.shard(b), lr)
        losses.append(float(loss[0]))
    sim.assert_replicated(params)
    return start, losses, _np(jax.tree_util.tree_map(lambda x: x[0], params)), _np(bn)


@pytest.fixture(scope="module")
def reference_steps(small):
    return _reference_steps(small)


def _port_steps(params0, bn0, q0):
    """The port's three steps from the reference's start: losses, and the
    parameters and BN state as numpy trees."""
    cfg = resnet.ResNetConfig(**SMALL)
    sim = SimMesh(W)
    comp = make_compressor("powersgd", rank=RANK)
    params = bridge.to_torch(params0)
    specs = resnet.mspecs(params)
    bn = sim.replicate(bridge.to_torch(bn0))
    ef = error_feedback.EFState(
        error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
        momentum=tree.map(torch.zeros_like, params), comp=bridge.to_torch(q0))
    grad = sim.run(grad_with_aux(resnet.loss_fn), in_axes=(None, 0, 0, None))
    losses = []
    for i, b in enumerate(_batches(8, 4, 8)):
        grads, (bn, met) = grad(params, bn, sim.shard(bridge.to_torch(b)), cfg)
        params, ef, _ = error_feedback.apply_updates(
            comp, params, grads, ef, specs,
            lr=schedules.paper_cifar_schedule(i, 0.1, W, PER_EPOCH), momentum=0.9,
            weight_decay=WD, ctx=sim.ctx())
        losses.append(met["loss"].mean().item())
    assert ef.step == STEPS
    return losses, bridge.to_numpy(params), bridge.to_numpy(bn)


def test_three_powersgd_steps_match_reference(reference_steps):
    (params0, bn0, q0), want_losses, want_params, want_bn = reference_steps
    losses, params, bn = _port_steps(params0, bn0, q0)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_trees_close(params, want_params, atol=2e-6)
    _assert_trees_close(bn, want_bn, atol=2e-6)


def test_resnet_trains():
    """25 EF-PowerSGD steps on Gaussian clusters raise the accuracy by 0.2
    (the twin of the reference's system test, one worker)."""
    cfg = resnet.ResNetConfig(**SMALL)
    gen = torch.Generator().manual_seed(0)
    params, bn = resnet.init(cfg, gen, device="cpu")
    specs = resnet.mspecs(params)
    comp = make_compressor("powersgd", rank=2)
    ef = error_feedback.init_state(comp, params, specs, generator=gen)
    data = GaussianClusters(num_classes=4, image_size=8, noise=0.5)
    grad = grad_with_aux(resnet.loss_fn)
    accs = []
    for i in range(25):
        grads, (bn, met) = grad(params, bn, bridge.to_torch(data.sample(64, i)), cfg)
        params, ef, _ = error_feedback.apply_updates(comp, params, grads, ef, specs,
                                                     lr=0.05, momentum=0.9)
        accs.append(met["acc"].item())
    assert np.mean(accs[-5:]) > np.mean(accs[:5]) + 0.2, accs


def _max_gap(got, want):
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               for (_, g), (_, w) in zip(tree.items(got), tree.items(want)))


def _nudged(t):
    """A copy of tree ``t`` with every float moved up by one ulp."""
    return tree.map(lambda x: torch.nextafter(x, torch.full_like(x, math.inf)), t)


if __name__ == "__main__":
    # The measured gaps behind the tolerances above, and behind
    # chip_smoke.py's RESNET_PARAM_ATOL (the last three at the paper's
    # width on the CPU: a few minutes).
    import pathlib
    import sys
    import types

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro.core import compressors as jcompressors
    from repro_torch.bench import common as bench
    from repro_torch.core import compressors
    from repro_torch.data.synthetic import MarkovLM as PMarkovLM
    from repro_torch.launch import train
    from repro_torch.models import lstm

    small_ = _small()
    print("forward, loss and gradients, largest gap:", max(
        _max_gap(*_forward_case(small_, size, mode))
        for size in (8, 7) for mode in (True, False)))
    (p0, bn0, q0), want_l, want_p, want_bn = _reference_steps(small_)
    losses, params, bn = _port_steps(p0, bn0, q0)
    print("three W = 2 steps: loss relative gap",
          max(abs(a - b) / abs(b) for a, b in zip(losses, want_l)),
          "parameters", _max_gap(params, want_p), "BN state", _max_gap(bn, want_bn),
          "largest parameter",
          max(float(np.abs(x).max()) for _, x in tree.items(want_p)))

    # float32 against float64 gradients at initialisation (8 images)
    cfg = resnet.paper_resnet18()
    p32, s32 = resnet.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    data = GaussianClusters(num_classes=10, image_size=32, channels=3, seed=0)
    b32 = bridge.to_torch(data.sample(8, 0))
    g32, _ = grad_with_aux(resnet.loss_fn)(p32, s32, b32, cfg)
    g64, _ = grad_with_aux(resnet.loss_fn)(
        tree.map(torch.Tensor.double, p32), tree.map(torch.Tensor.double, s32),
        {"images": b32["images"].double(), "labels": b32["labels"]}, cfg)
    print("float32 gradients at init against float64: largest gap",
          max((a.double() - b).abs().max().item()
              for a, b in zip(tree.leaves(g32), tree.leaves(g64))),
          "largest gradient", max(a.abs().max().item() for a in tree.leaves(g32)))

    # chip_smoke's card-against-CPU run on the CPU, from its initial
    # parameters and from those moved by one ulp
    pm = types.SimpleNamespace(
        resnet=resnet, lstm=lstm, SimMesh=SimMesh, GaussianClusters=GaussianClusters,
        MarkovLM=PMarkovLM, compressors=compressors, error_feedback=error_feedback,
        schedules=schedules, train=train, tree=tree, bench=bench)
    for name in ("powersgd", "identity"):
        ends = []
        for nudge in (False, True):
            tr = chip_smoke.PaperTrainer(torch, pm, "resnet18",
                                         chip_smoke.PAPER_CPU_WORKERS, "cpu")
            if name == "identity":
                tr.comp = compressors.make_compressor("identity")
            st = tr.init()
            if nudge:
                st["params"] = _nudged(st["params"])
            batch = chip_smoke.PAPER["resnet18"][2] // chip_smoke.PAPER_CPU_WORKERS
            ls = [tr.step(st, b).item()
                  for b in tr.batches(batch, chip_smoke.PAPER_CPU_STEPS)]
            ends.append((ls, bridge.to_numpy({"p": st["params"], "bn": st["bn"]})))
        (la, ta), (lb, tb) = ends
        print(f"chip_smoke's ResNet comparison on the CPU ({name}): one ulp "
              f"moves the parameters and BN state by {_max_gap(ta, tb):.2e}, the "
              f"losses by {max(abs(a - b) / abs(a) for a, b in zip(la, lb)):.2e} "
              f"relative ({la})")

    # the paper's lr 0.1 on this data, both packages, one worker of 16
    # images, identity, momentum 0.9, weight decay 1e-4, from one start
    p, s = resnet.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    # copies: the port updates its parameters in place
    jp, js = (jax.tree_util.tree_map(jnp.array, bridge.to_numpy(t)) for t in (p, s))
    specs, jspecs = resnet.mspecs(p), jresnet.mspecs(jp)
    comp, jcomp_ = make_compressor("identity"), jcompressors.make_compressor("identity")
    ef = error_feedback.init_state(comp, p, specs)
    jef_state = jef.init_state(jcomp_, jp, jspecs, KEY)
    jgrad = jax.jit(jax.grad(jresnet.loss_fn, has_aux=True), static_argnums=3)
    port, ref = [], []
    for i in range(3):
        b = data.sample(16, i)
        g, (s, m) = grad_with_aux(resnet.loss_fn)(p, s, bridge.to_torch(b), cfg)
        p, ef, _ = error_feedback.apply_updates(comp, p, g, ef, specs, lr=0.1,
                                                momentum=0.9, weight_decay=1e-4)
        port.append(m["loss"].item())
        jg, (js, jm) = jgrad(jp, js, {k: jnp.asarray(v) for k, v in b.items()},
                             jresnet.paper_resnet18())
        jp, jef_state, _ = jef.apply_updates(jcomp_, jp, jg, jef_state, jspecs,
                                             lr=0.1, momentum=0.9, weight_decay=1e-4,
                                             key=KEY)
        ref.append(float(jm["loss"]))
    print("ResNet-18 at lr 0.1 on GaussianClusters, losses: port", port,
          "reference", ref)
