"""The architectures' building blocks, held against the JAX package on the
same numpy inputs (``repro_torch.bridge``), on the CPU:

* every registered configuration, full and reduced, field by field, with
  its properties, both parameter counts and the aliases; ``INPUT_SHAPES``;
* every configuration's parameter shapes (at one and two model shards) and
  its ``pspecs``/``mspecs`` leaves;
* Mamba-2's initial vectors bit for bit (``A_log = log(linspace(1, 16,
  h))``, ``D``, ``dt_bias``, the norm scale);
* the MoE layer's output, auxiliary loss and gradients, dropping (a
  capacity factor of 0.5) and dropless, and at a model index of 1 with
  half the experts local;
* the Mamba-2 layer's output and gradients over two SSD chunks, and
  ``_ssd_scan``'s output and final state over four;
* sliding-window attention (``_windowed_chunks``) and qk-norm, output and
  gradients;
* ``default_spec`` and the ``cosine`` schedule.

Tolerances: outputs and losses rtol 1e-5 (float32 with other summation
orders); gradients atol 1e-5 relative to each leaf's largest magnitude
(``GRAD_RTOL``): the MoE combine sums the k slots in another order than
the reference's indexed add (ROADMAP C6), and the SSD scan's chunked sums
run over another order too; Mamba-2's per-head ``A_log``, ``D`` and
``dt_bias`` within 1e-4 (``SCAN_VECTOR_GRAD_RTOL``).  ``python tests/test_torch_arch_models.py``
prints the gaps.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import dist as jdist
from repro.core import matrixize as jmatrixize
from repro.models import attention as jattention
from repro.models import mamba2 as jmamba2
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.optim import schedules as jschedules
from repro_torch import bridge, tree
from repro_torch.configs import base
from repro_torch.core import matrixize
from repro_torch.models import attention, mamba2, model, moe
from repro_torch.optim import schedules


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


OUT_RTOL, GRAD_RTOL = 1e-5, 1e-5
# Mamba-2's per-head A_log, D and dt_bias: each gradient entry sums over
# every token, state entry and head dim of the scan with cancellation
# (measured 1.1e-5, 1.9e-6 and 2.6e-5 of the leaf's largest magnitude here;
# D 1.02e-5 in tests/test_torch_tp.py)
SCAN_VECTOR_GRAD_RTOL = 1e-4
ARCHS = list(base.ARCH_IDS)


class _Shard(jdist.MeshCtx):
    """The reference's single-device context at another model index (what
    ``shard_map`` gives the rank of that index), without a model axis to
    sum over: the port's twin is :class:`_PortShard`."""

    def model_index(self):
        return 1


def _port_shard():
    from repro_torch.core.dist import MeshCtx

    class _PortShard(MeshCtx):
        def model_index(self):
            return 1
    return _PortShard()


def _rng(seed):
    return np.random.default_rng(seed)


def _gap(got, want):
    """Largest absolute difference over the largest magnitude."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# configurations and specs
# ---------------------------------------------------------------------------

def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d["slots"] = [(s["mixer"], s["ffn"]) for s in d["slots"]]
    return d


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    assert ([f.name for f in dataclasses.fields(base.ModelConfig)]
            == [f.name for f in dataclasses.fields(jbase.ModelConfig)])
    for reduced in (False, True):
        cfg, jcfg = base.get_config(arch, reduced), jbase.get_config(arch, reduced)
        assert _fields(cfg) == _fields(jcfg)
        for prop in ("period", "num_periods", "resolved_head_dim",
                     "ssm_d_inner", "ssm_heads"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), prop
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()


def test_registry_matches_reference():
    assert base.ARCH_IDS == jbase.ARCH_IDS
    assert base.ARCH_ALIASES == jbase.ARCH_ALIASES
    for alias, arch in base.ARCH_ALIASES.items():
        assert base.get_config(alias) == base.get_config(arch)
    assert ({k: dataclasses.astuple(v) for k, v in base.INPUT_SHAPES.items()}
            == {k: dataclasses.astuple(v) for k, v in jbase.INPUT_SHAPES.items()})
    with pytest.raises(ValueError, match="unknown architecture"):
        base.get_config("gpt2")


def _spec_entries(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_specs_match_reference(arch):
    for reduced in (True, False):
        cfg, jcfg = base.get_config(arch, reduced), jbase.get_config(arch, reduced)
        for shards in (1, 2):
            params = model.init(cfg, None, "meta", model_shards=shards)
            jshapes = jax.eval_shape(lambda: jmodel.init(
                jax.random.key(0), jcfg, model_shards=shards))
            assert [tuple(p.shape) for p in tree.leaves(params)] == [
                s.shape for s in jax.tree_util.tree_leaves(jshapes)]
        jps = jax.tree_util.tree_leaves(
            jmodel.pspecs(jcfg),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert [_spec_entries(s) for s in tree.leaves(model.pspecs(cfg))] == [
            _spec_entries(s) for s in jps]
        jms = jax.tree_util.tree_leaves(
            jmodel.mspecs(jcfg),
            is_leaf=lambda x: isinstance(x, jmatrixize.MatrixSpec))
        assert [(m.kind, m.batch_dims) for m in tree.leaves(model.mspecs(cfg))] == [
            (m.kind, m.batch_dims) for m in jms]


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "jamba_v01_52b"])
def test_mamba_initial_vectors_are_exact(arch):
    for reduced in (True, False):
        cfg, jcfg = base.get_config(arch, reduced), jbase.get_config(arch, reduced)
        h = cfg.ssm_heads
        want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, h, dtype=jnp.float32)))
        assert np.array_equal(mamba2._a_log(h).numpy(), want)
    cfg, jcfg = base.get_config(arch, True), jbase.get_config(arch, True)
    got = mamba2.init(cfg, torch.Generator().manual_seed(0))
    ref = jmamba2.init(jax.random.key(0), jcfg, 1)
    for name in ("dt_bias", "A_log", "D", "norm_scale"):
        assert np.array_equal(got[name].numpy(), np.asarray(ref[name])), name
    for name in ref:
        assert tuple(got[name].shape) == ref[name].shape, name


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_case(cf, seed=0):
    cfg = dataclasses.replace(base.get_config("qwen3_moe_30b_a3b", True),
                              moe_capacity_factor=cf)
    jcfg = dataclasses.replace(jbase.get_config("qwen3_moe_30b_a3b", True),
                               moe_capacity_factor=cf)
    params = jax.tree_util.tree_map(
        np.asarray, jmoe.init(jax.random.key(seed), jcfg))
    x = _rng(seed).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    ct = _rng(seed + 1).standard_normal(x.shape).astype(np.float32)
    return cfg, jcfg, params, x, ct


def _moe_pair(cf, dropless, half=False):
    """Both packages' (out, aux) and gradients of ⟨out, ct⟩ + aux, with
    respect to the parameters and x; ``half``: model index 1, the last
    half of the experts local (no model axis to sum over)."""
    cfg, jcfg, params, x, ct = _moe_case(cf)
    if half:
        e = cfg.moe_num_experts // 2
        params = {k: v if k == "router" else v[e:] for k, v in params.items()}
    jctx = _Shard() if half else jdist.SINGLE
    pctx = _port_shard() if half else None

    def jfn(p, xx):
        out, aux = jmoe.forward(p, xx, jcfg, jctx, dropless=dropless)
        return jnp.sum(out * ct) + aux, (out, aux)

    (jv, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    p = tree.map(lambda a: a.requires_grad_(True), bridge.to_torch(params))
    xt = torch.tensor(x, requires_grad=True)
    kw = {} if pctx is None else {"ctx": pctx}
    out, aux = moe.forward(p, xt, cfg, dropless=dropless, **kw)
    v = torch.sum(out * torch.tensor(ct)) + aux
    g = torch.autograd.grad(v, tree.leaves(p) + [xt])
    return (out, aux, g), (jout, jaux, jax.tree_util.tree_leaves(jg))


def _moe_gaps(cf, dropless, half=False):
    (out, aux, g), (jout, jaux, jg) = _moe_pair(cf, dropless, half)
    return (_gap(out.detach().numpy(), jout),
            abs(aux.item() - float(jaux)) / abs(float(jaux)),
            max(_gap(a.numpy(), b) for a, b in zip(g, jg)))


@pytest.mark.parametrize("cf,dropless,half", [
    (0.5, False, False), (1.25, True, False), (0.5, False, True)],
    ids=["dropping", "dropless", "dropping-model-index-1"])
def test_moe_forward_and_grads_match_reference(cf, dropless, half):
    out_gap, aux_gap, grad_gap = _moe_gaps(cf, dropless, half)
    assert out_gap <= OUT_RTOL and aux_gap <= OUT_RTOL
    assert grad_gap <= GRAD_RTOL


def test_moe_capacity_drops_tokens():
    """At a capacity factor of 0.5 pairs are dropped (the output differs
    from the dropless one); ``capacity`` is the reference's for every MoE
    configuration."""
    cfg, _, params, x, _ = _moe_case(0.5)
    p, xt = bridge.to_torch(params), torch.tensor(x)
    dropped = moe.forward(p, xt, cfg)[0]
    whole = moe.forward(p, xt, cfg, dropless=True)[0]
    assert not torch.allclose(dropped, whole)
    for arch in ("qwen3_moe_30b_a3b", "olmoe_1b_7b", "jamba_v01_52b"):
        for reduced in (False, True):
            c, jc = base.get_config(arch, reduced), jbase.get_config(arch, reduced)
            for t in (1, 7, 48, 1024, 5000):
                assert moe.capacity(c, t) == jmoe.capacity(jc, t)
    assert moe.capacity(base.get_config("qwen3_moe_30b_a3b"), 1024) == 80


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

def _mamba_case(seq=128):
    cfg, jcfg = base.get_config("mamba2_1p3b", True), jbase.get_config("mamba2_1p3b", True)
    params = jax.tree_util.tree_map(np.asarray, jmamba2.init(jax.random.key(3), jcfg, 1))
    # move the constant vectors off their initial values, so that their
    # gradients and the scan's decays are exercised at generic points
    r = _rng(4)
    for name in ("dt_bias", "A_log", "D", "norm_scale"):
        params[name] = (params[name] + 0.3 * r.standard_normal(
            params[name].shape)).astype(np.float32)
    x = r.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    ct = r.standard_normal(x.shape).astype(np.float32)
    return cfg, jcfg, params, x, ct


def _mamba_gaps():
    cfg, jcfg, params, x, ct = _mamba_case()

    def jfn(p, xx):
        return jnp.sum(jmamba2.forward(p, xx, jcfg, jdist.SINGLE) * ct)

    (jv, jg) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(params, jnp.asarray(x))
    p = tree.map(lambda a: a.requires_grad_(True), bridge.to_torch(params))
    xt = torch.tensor(x, requires_grad=True)
    out = mamba2.forward(p, xt, cfg)
    v = torch.sum(out * torch.tensor(ct))
    g = torch.autograd.grad(v, tree.leaves(p) + [xt])
    jout = jmamba2.forward(params, jnp.asarray(x), jcfg, jdist.SINGLE)
    names = [path[-1] for path, _ in tree.items(p)] + ["x"]
    return (_gap(out.detach().numpy(), jout),
            {n: _gap(a.numpy(), b)
             for n, a, b in zip(names, g, jax.tree_util.tree_leaves(jg))},
            all(np.isfinite(a.numpy()).all() for a in g))


def test_mamba_forward_and_grads_match_reference():
    out_gap, grad_gaps, finite = _mamba_gaps()
    assert finite and out_gap <= OUT_RTOL
    for name, gap in grad_gaps.items():
        limit = (SCAN_VECTOR_GRAD_RTOL if name in ("A_log", "D", "dt_bias")
                 else GRAD_RTOL)
        assert gap <= limit, (name, gap)


def _scan_inputs(seed=5, s=96, chunk=24):
    r = _rng(seed)
    b, h, p, n = 2, 3, 8, 5
    xh = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    bmat = r.standard_normal((b, s, n)).astype(np.float32)
    cmat = r.standard_normal((b, s, n)).astype(np.float32)
    a_neg = -np.exp(r.standard_normal(h)).astype(np.float32)
    return (xh, dt, bmat, cmat, a_neg), chunk


def _scan_gaps():
    args, chunk = _scan_inputs()
    jy, jh = jmamba2._ssd_scan(*map(jnp.asarray, args), chunk)
    y, h = mamba2._ssd_scan(*map(torch.tensor, args), chunk)
    return _gap(y.numpy(), jy), _gap(h.numpy(), jh), tuple(h.shape) == jh.shape


def test_ssd_scan_matches_reference():
    y_gap, h_gap, same_shape = _scan_gaps()
    assert same_shape and y_gap <= OUT_RTOL and h_gap <= OUT_RTOL


def test_ssd_scan_raises_on_a_ragged_sequence():
    args, _ = _scan_inputs(s=100)
    with pytest.raises(ValueError, match="no multiple"):
        mamba2._ssd_scan(*map(torch.tensor, args), 64)


# ---------------------------------------------------------------------------
# attention: sliding window, qk-norm
# ---------------------------------------------------------------------------

def _attn_gaps(arch, window, q_chunk, seq=48):
    cfg, jcfg = base.get_config(arch, True), jbase.get_config(arch, True)
    params = jax.tree_util.tree_map(
        np.asarray, jattention.init(jax.random.key(6), jcfg, 1))
    r = _rng(7)
    for name in ("q_norm", "k_norm"):
        if name in params:
            params[name] = (1 + 0.2 * r.standard_normal(
                params[name].shape)).astype(np.float32)
    x = r.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    ct = r.standard_normal(x.shape).astype(np.float32)

    def jfn(p, xx):
        return jnp.sum(jattention.forward(p, xx, jcfg, jdist.SINGLE,
                                          q_chunk=q_chunk, window=window) * ct)

    jv, jg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(params, jnp.asarray(x))
    jout = jattention.forward(params, jnp.asarray(x), jcfg, jdist.SINGLE,
                              q_chunk=q_chunk, window=window)
    p = tree.map(lambda a: a.requires_grad_(True), bridge.to_torch(params))
    xt = torch.tensor(x, requires_grad=True)
    out = attention.forward(p, xt, cfg, q_chunk=q_chunk, window=window)
    g = torch.autograd.grad(torch.sum(out * torch.tensor(ct)),
                            tree.leaves(p) + [xt])
    return (_gap(out.detach().numpy(), jout),
            max(_gap(a.numpy(), b) for a, b in zip(g, jax.tree_util.tree_leaves(jg))))


ATTN_CASES = [("llama3_8b", 8, 8), ("llama3_8b", 20, 16), ("qwen3_4b", 0, 16),
              ("qwen3_moe_30b_a3b", 12, 16)]


@pytest.mark.parametrize("arch,window,q_chunk", ATTN_CASES,
                         ids=[f"{a}-w{w}-q{q}" for a, w, q in ATTN_CASES])
def test_window_and_qk_norm_match_reference(arch, window, q_chunk):
    out_gap, grad_gap = _attn_gaps(arch, window, q_chunk)
    assert out_gap <= OUT_RTOL and grad_gap <= GRAD_RTOL


def test_window_past_the_sequence_is_full_attention():
    """A window of S or more is full attention, bit for bit; on a ragged
    last chunk (S = 30, chunks of 8) every key in the window stays in reach:
    the result is the one-chunk result's (the JAX package's windowed path
    clamps its last slice there, ROADMAP C3, so the port is held against
    itself)."""
    cfg = base.get_config("llama3_8b", True)
    params = attention.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((1, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    full = attention.forward(params, x, cfg, q_chunk=8)
    assert torch.equal(attention.forward(params, x, cfg, q_chunk=8, window=32), full)
    ragged = attention.forward(params, x[:, :30], cfg, q_chunk=8, window=12)
    whole = attention.forward(params, x[:, :30], cfg, q_chunk=30, window=12)
    torch.testing.assert_close(ragged, whole, rtol=OUT_RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# default_spec, cosine
# ---------------------------------------------------------------------------

def test_default_spec_matches_reference():
    for shape in ((), (7,), (3, 4), (2, 3, 4), (2, 3, 4, 5), (1, 2, 3, 4, 5)):
        for b in range(0, len(shape) + 1):
            leaf = torch.empty(shape, device="meta")
            got = matrixize.default_spec(leaf, b)
            want = jmatrixize.default_spec(jax.ShapeDtypeStruct(shape, jnp.float32), b)
            assert (got.kind, got.batch_dims) == (want.kind, want.batch_dims)


def test_cosine_matches_reference():
    for total in (0, 1, 10, 1000):
        for step in (0, 1, 5, 10, 999, 1000, 2000):
            for min_frac in (0.0, 0.1):
                np.testing.assert_allclose(
                    schedules.cosine(step, 0.3, total, min_frac),
                    float(jschedules.cosine(step, 0.3, total, min_frac)),
                    rtol=1e-6, atol=1e-7)


if __name__ == "__main__":
    print("moe (out, aux, grad) gaps:",
          {f"cf={cf} dropless={d} half={h}": _moe_gaps(cf, d, h)
           for cf, d, h in ((0.5, False, False), (1.25, True, False),
                            (0.5, False, True))})
    print("mamba (out, grad) gaps:", _mamba_gaps()[:2])
    print("ssd scan (y, h) gaps:", _scan_gaps()[:2])
    for case in ATTN_CASES:
        print("attention", case, "(out, grad) gaps:", _attn_gaps(*case))
    sys.exit(0)
