"""The port's dense LM against the JAX package's: loss value and gradients of
reduced Llama-3-8B on the same parameters (carried over by
``repro_torch.bridge``), plus the bridge round trip, configs, specs and the
synthetic data copy.  Tolerances: loss rtol 1e-5, grads atol 2e-6 /
rtol 1e-4 (fp32, different reduction orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jllama
from repro.core import powersgd as jpsgd
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.models import model as jmodel
from repro_torch import bridge, tree
from repro_torch.configs import base, llama3_8b
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import train
from repro_torch.models import model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jllama.reduced_config(), llama3_8b.reduced_config()
    jparams = jmodel.init(jax.random.key(0), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    toks = JMarkovLM(vocab=cfg.vocab_size, seed=3, order=1).sample(2, 48, step=0)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1                      # masked positions
    batch = {"tokens": toks[:, :-1], "labels": labels}
    return jcfg, cfg, jparams, params_np, batch


def test_loss_and_grads_match_reference(setup):
    jcfg, cfg, jparams, params_np, batch = setup

    def jloss(p):
        return jmodel.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                              jcfg, q_chunk=16, remat=False)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    params = tree.map(lambda x: x.requires_grad_(True), bridge.to_torch(params_np))
    loss, metrics = model.loss_fn(
        params, {k: torch.tensor(v) for k, v in batch.items()}, cfg, q_chunk=16)
    grads = torch.autograd.grad(loss, tree.leaves(params))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    # no MoE layer: the total adds a zero auxiliary loss and is the lm_loss
    assert torch.equal(metrics["lm_loss"], loss)
    jg_np = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jg))
    paths = [path for path, _ in tree.items(params)]
    for path, got, want in zip(paths, grads, jg_np):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-4,
                                   err_msg=str(path))


@pytest.mark.cuda
def test_cuda_grads_are_deterministic(setup):
    """Two backward passes on the card give the same bits: the kv heads are
    shared out by an expand, whose backward is a sum (index_select's
    backward adds with atomics on the card, in an order that changes from
    run to run); so are an MoE layer's tokens, and its k slots are summed
    (reduced Qwen3-30B-A3B)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, cfg, _, params_np, batch = setup
    moe_cfg = base.get_config("qwen3_moe_30b_a3b", reduced=True)
    tb = {k: torch.tensor(v, device="cuda") for k, v in batch.items()}
    for c, params in (
            (cfg, bridge.to_torch(params_np, device="cuda")),
            (moe_cfg, model.init(moe_cfg, torch.Generator("cuda").manual_seed(0),
                                 device="cuda"))):
        first, second = (train.local_grads(c, params, tb, q_chunk=16,
                                           device="cuda") for _ in range(2))
        assert torch.equal(first[1]["lm_loss"], second[1]["lm_loss"])
        for path, a, b in zip(tree.items(params), first[0], second[0]):
            assert torch.equal(a, b), (c.name, path[0])


def test_q_chunking_does_not_change_the_loss(setup):
    _, cfg, _, params_np, batch = setup
    params = bridge.to_torch(params_np)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    whole = model.loss_fn(params, tb, cfg, q_chunk=64)[0]
    chunked = model.loss_fn(params, tb, cfg, q_chunk=20)[0]
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=0)


def test_bridge_roundtrip_is_bit_identical(setup):
    jcfg, _, jparams, params_np, _ = setup
    back = bridge.to_numpy(bridge.to_torch(params_np))
    for a, b in zip(jax.tree_util.tree_leaves(params_np), tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    shapes = jax.tree_util.tree_map(
        lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), jparams)
    q = jpsgd.init_state(jpsgd.PowerSGDConfig(rank=2), shapes,
                         jmodel.mspecs(jcfg), jax.random.key(1))
    q_np = jax.tree_util.tree_map(lambda x: None if x is None else np.asarray(x),
                                  q, is_leaf=lambda x: x is None)
    q_back = bridge.to_numpy(bridge.to_torch(q_np))
    flat = lambda t: jax.tree_util.tree_leaves(t, is_leaf=lambda x: x is None)
    for a, b in zip(flat(q_np), tree.leaves(q_back)):
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_specs_match_reference(reduced):
    jcfg = jllama.reduced_config() if reduced else jllama.config()
    cfg = base.get_config("llama3-8b", reduced=reduced)
    for f in dataclasses.fields(cfg):
        if f.name != "slots":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert [(s.mixer, s.ffn) for s in cfg.slots] == [(s.mixer, s.ffn) for s in jcfg.slots]
    jspecs = jax.tree_util.tree_leaves(jmodel.mspecs(jcfg))
    specs = tree.leaves(model.mspecs(cfg))
    assert [(s.kind, s.batch_dims) for s in specs] == [(s.kind, s.batch_dims)
                                                       for s in jspecs]


def test_unported_architectures_raise():
    """Every architecture id and alias resolves, full and reduced (the
    training half of item 15 is ported); the decode and prefill entry
    points still raise naming item 15."""
    for arch in base.ARCH_IDS + list(base.ARCH_ALIASES):
        for reduced in (False, True):
            cfg = base.get_config(arch, reduced=reduced)
            assert cfg.num_periods * cfg.period == cfg.num_layers
    for stub in (model.init_cache, model.decode_step, model.prefill_step):
        with pytest.raises(NotImplementedError, match="item 15"):
            stub(None, None)


def test_init_shapes_and_count_match_reference():
    cfg = llama3_8b.reduced_config()
    params = model.init(cfg, torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                 jllama.reduced_config()))
    assert [tuple(p.shape) for p in tree.leaves(params)] == [
        s.shape for s in jax.tree_util.tree_leaves(jshapes)]
    norms = sum(p.numel() for path, p in tree.items(params) if "norm" in path[-1])
    assert sum(p.numel() for p in tree.leaves(params)) == cfg.param_count() + norms


def test_markov_copy_matches_reference():
    for order in (1, 2):
        a = MarkovLM(vocab=97, seed=5, order=order, clusters=3).sample(3, 20, step=4)
        b = JMarkovLM(vocab=97, seed=5, order=order, clusters=3).sample(3, 20, step=4)
        np.testing.assert_array_equal(a, b)
