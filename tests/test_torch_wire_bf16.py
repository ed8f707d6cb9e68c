"""The bfloat16 cast wire (``wire_dtype="bfloat16"``) against the JAX
package, on the same numpy inputs.

* Plans: ``plan_flat`` on float-only parts equals the reference's chunk for
  chunk and slot for slot; on mixed parts the port keeps the integer parts
  in an exact chunk of their own dtype (a declared divergence, as on the
  float32 wire): the reference's bfloat16 wire rounds index 257 to 256, the
  port's keeps it, and the reference's Top-K then scatters to wrong
  coordinates where the port's does not.
* Casts: ``pack_flat``/``unpack_flat`` bit for bit against the reference's
  (round to nearest even, ties, subnormals, infinities, NaN).
* The reduce: ``pmean_flat``, ``psum_data`` and the weighted mean on the
  bfloat16 wire over ``SimMesh(W)``, W ∈ {2, 3, 4, 16}, bit for bit
  against the reference's ``vmap``'d collectives (its sum folds the workers
  in order, rounding to bfloat16 after each add), weights with zeros; the
  fold leaves its input alone, ``in_place=True`` too gives the same bits.
* PowerSGD: every reduce of a W = 4 step, fed the port's own pre-cast
  payloads, bit-equal to the reference's reduce of the same payloads; the
  whole step against the reference's under a flip-aware rule (see
  ``BF16_ATOL``); records at itemsize 2 and the sizes of the float32 wire.
* Top-K on the bfloat16 wire at W = 2: the aggregate is the mean of every
  worker's payload values rounded to bfloat16 and scattered at its int32
  indices, on a leaf of 1,600 coordinates.

``PYTHONPATH=src python tests/test_torch_wire_bf16.py`` prints the one-ulp
runs behind ``chip_smoke.py``'s card-against-CPU rules on this wire:
reduced Llama-3-8B and the tuned benchmark LM from initial parameters
moved by one ulp, on the float32 and the bfloat16 wire.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import dist as jdist
from repro.core import matrixize as jmz
from repro.core import powersgd as jpsgd
from repro.core.simmesh import SimMesh as JSimMesh
from repro_torch import bridge
from repro_torch.core import compressors, dist, matrixize as mz, powersgd
from repro_torch.core.simmesh import SimMesh


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KEY = jax.random.key(0)
WIRE = "bfloat16"


def _bits(x) -> np.ndarray:
    """The bit patterns of a bfloat16 tensor or array, as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _parts(seed, shapes, lead=()):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(lead + s).astype(np.float32) * 3.0 ** (i - 2)
            for i, s in enumerate(shapes)]


SHAPES = [(7,), (3, 5), (2, 4, 6), (33,), (1,)]


# ---------------------------------------------------------------------------
# plans and casts
# ---------------------------------------------------------------------------

def _chunks(plan):
    return [(c.quant, c.size, c.wire_bytes, c.wire_itemsize,
             [(s.index, s.offset, s.size, s.shape) for s in c.slots])
            for c in plan.chunks]


@pytest.mark.parametrize("max_chunk_bytes", [None, 64, 150])
def test_plan_flat_float_parts_equal_reference(max_chunk_bytes):
    parts = _parts(0, SHAPES)
    plan = mz.plan_flat([torch.tensor(p) for p in parts], wire_dtype=WIRE,
                        max_chunk_bytes=max_chunk_bytes)
    jplan = jmz.plan_flat([jnp.asarray(p) for p in parts], wire_dtype=WIRE,
                          max_chunk_bytes=max_chunk_bytes)
    assert _chunks(plan) == _chunks(jplan)
    assert all(c.wire_dtype == torch.bfloat16 for c in plan.chunks)
    assert plan.total_wire_bytes == jplan.total_wire_bytes == 2 * sum(
        p.size for p in parts)


def test_plan_flat_mixed_parts_differ_only_by_integer_chunk():
    parts = _parts(1, SHAPES[:3])
    ints = [np.arange(5, dtype=np.int32), np.arange(3, dtype=np.int8)]
    mixed = [parts[0], ints[0], parts[1], ints[1], parts[2]]
    plan = mz.plan_flat([torch.tensor(p) for p in mixed], wire_dtype=WIRE)
    jplan = jmz.plan_flat([jnp.asarray(p) for p in mixed], wire_dtype=WIRE)
    # the reference casts everything into one bfloat16 chunk
    assert [c.wire_dtype for c in jplan.chunks] == [jnp.bfloat16]
    assert [c.wire_dtype for c in plan.chunks] == [torch.bfloat16, torch.int32,
                                                   torch.int8]
    floats = mz.plan_flat([torch.tensor(p) for p in parts], wire_dtype=WIRE)
    assert ([s.size for s in plan.chunks[0].slots]
            == [s.size for s in floats.chunks[0].slots])
    assert [s.index for s in plan.chunks[0].slots] == [0, 2, 4]
    assert [[s.index for s in c.slots] for c in plan.chunks[1:]] == [[1], [3]]
    assert plan.chunks[0].wire_bytes == 2 * sum(p.size for p in parts)


def test_pack_unpack_bit_equal_reference():
    """Round to nearest even, as ``astype``: ties, carries into the
    exponent, subnormals, overflow to infinity, signed zeros.  A NaN stays
    a NaN, but not bit for bit: torch writes 0xFFFF for every float32 NaN,
    XLA a quiet NaN of the input's sign (0x7FC0 / 0xFFC0)."""
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    special = np.array([0x3F808000, 0x3F818000, 0x3F80FFFF, 0x7F7FFFFF, 0x00000001,
                        0x80008000, 0x00800000, 0x7F800000, 0xFF800000, 0x80000000,
                        0x3F7F8000, 0x477FE000, 0x7FC00000], np.uint32)
    vals = np.concatenate([u, special]).view(np.float32)
    parts = [vals[:1000].reshape(40, 25), vals[1000:].copy(),
             rng.standard_normal((3, 11)).astype(np.float32)]
    lead = np.stack([p.reshape(-1)[:33] for p in parts])   # a (3, 33) stack
    for group, nl in ((parts, 0), ([lead, 2 * lead], 1)):
        plan = mz.plan_flat([torch.tensor(p) for p in group], wire_dtype=WIRE,
                            lead=nl)
        jplan = jmz.plan_flat([jnp.asarray(p[0] if nl else p) for p in group],
                              wire_dtype=WIRE)
        for chunk, jchunk in zip(plan.chunks, jplan.chunks):
            buf = mz.pack_flat(chunk, [torch.tensor(p) for p in group], lead=nl)
            jbuf = (jax.vmap(lambda *ps: jmz.pack_flat(jchunk, ps))(
                *[jnp.asarray(p) for p in group]) if nl
                else jmz.pack_flat(jchunk, [jnp.asarray(p) for p in group]))
            assert buf.dtype == torch.bfloat16
            nan = torch.isnan(buf).numpy()
            np.testing.assert_array_equal(nan, np.isnan(np.asarray(jbuf, np.float32)))
            np.testing.assert_array_equal(_bits(buf)[~nan], _bits(jbuf)[~nan])
            out = mz.unpack_flat(chunk, buf, leading=buf.shape[:nl])
            jout = (jax.vmap(lambda b: jmz.unpack_flat(jchunk, b))(jbuf) if nl
                    else jmz.unpack_flat(jchunk, jbuf))
            for i, x in out.items():
                assert x.dtype == torch.float32
                y, ok = np.asarray(jout[i]), ~np.isnan(x.numpy())
                np.testing.assert_array_equal(ok, ~np.isnan(y))
                np.testing.assert_array_equal(x.numpy()[ok].view(np.uint32),
                                              y[ok].view(np.uint32))


def test_reference_bf16_wire_rounds_index_257_port_keeps_it():
    """An int32 index above 2⁸ travels in the reference's bfloat16 chunk
    and rounds (257 → 256, 259 → 260); the port's int32 chunk keeps it.
    Beside ``tests/test_torch_topk.py::
    test_topk_float32_wire_large_leaf_agg_equals_recon`` (float32, 2²⁴)."""
    idx = np.arange(250, 262, dtype=np.int32)
    vals = np.linspace(1, 2, 12, dtype=np.float32)
    jplan = jmz.plan_flat([jnp.asarray(vals), jnp.asarray(idx)], wire_dtype=WIRE)
    (jchunk,) = jplan.chunks
    jback = jmz.unpack_flat(jchunk, jmz.pack_flat(
        jchunk, [jnp.asarray(vals), jnp.asarray(idx)]))[1]
    assert np.asarray(jback).tolist() == [250, 251, 252, 253, 254, 255, 256, 256,
                                          258, 260, 260, 260]
    plan = mz.plan_flat([torch.tensor(vals), torch.tensor(idx)], wire_dtype=WIRE)
    back = {}
    for chunk in plan.chunks:
        back.update(mz.unpack_flat(chunk, mz.pack_flat(
            chunk, [torch.tensor(vals), torch.tensor(idx)])))
    assert back[1].dtype == torch.int32
    assert back[1].tolist() == idx.tolist()

    # Top-K at W = 1 on a 40 × 40 leaf whose selected coordinates sit at odd
    # indices above 2⁸: the port's aggregate is its own reconstruction,
    # every value at its index; the reference's lands elsewhere
    n, rank = 40, 1
    rng = np.random.default_rng(3)
    delta = rng.random(n * n, dtype=np.float32)
    sel = 257 + 2 * rng.choice((n * n - 257) // 2, 2 * n * rank, replace=False)
    delta[sel] = 10.0 + rng.random(sel.size, dtype=np.float32)
    d = delta.reshape(1, n, n)
    out = compressors.make_compressor("top_k", rank=rank, wire_dtype=WIRE).step(
        {"w": torch.tensor(d)}, None, {"w": mz.MatrixSpec("matrix", 0)},
        SimMesh(1).ctx())
    agg = out.agg["w"].reshape(-1)
    assert torch.equal(torch.nonzero(agg).squeeze(1),
                       torch.tensor(np.sort(sel), dtype=torch.long))
    want = torch.tensor(delta[sel]).to(torch.bfloat16).float()
    assert torch.equal(agg[sel], want)
    jc = jcomp.make_compressor("top_k", rank=rank, wire_dtype=WIRE)
    sim = JSimMesh(1)
    jagg = sim.run(lambda x: jc.step({"w": x}, None, {"w": jmz.MatrixSpec("matrix", 0)},
                                     ctx=sim.ctx(), key=KEY).agg["w"])(
        jnp.asarray(d[None]))
    jagg = np.asarray(jagg).reshape(-1)
    assert not np.array_equal(np.sort(np.nonzero(jagg)[0]), np.sort(sel))


# ---------------------------------------------------------------------------
# the reduce
# ---------------------------------------------------------------------------

def _weights(workers, weighted):
    if not weighted:
        return None
    w = np.random.default_rng(workers).uniform(0.5, 3.0, workers).astype(np.float32)
    w[1] = 0.0
    if workers > 3:
        w[3] = 0.0
    return w


def _reference_reduce(parts, workers, weights, op):
    """The reference's collective ``op`` (``"pmean_flat"`` or ``"psum"``)
    over ``SimMesh(workers)``, fed stacked numpy parts; worker 0's result
    and the stats."""
    sim, stats = JSimMesh(workers), jdist.CollectiveStats()
    w = jnp.ones(workers) if weights is None else jnp.asarray(weights)

    def worker(ps, wt):
        ctx = sim.ctx(weight=None if weights is None else wt, stats=stats)
        if op == "pmean_flat":
            return ctx.pmean_flat(list(ps), wire_dtype=WIRE)
        return [ctx.psum_data(p.astype(jnp.bfloat16)) for p in ps]

    out = sim.run(worker)([jnp.asarray(p) for p in parts], w)
    return [np.asarray(x[0]) for x in out], stats


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("workers", [2, 3, 4, 16])
def test_sim_reduce_bit_equal_reference(workers, weighted):
    parts = _parts(workers, SHAPES, lead=(workers,))
    weights = _weights(workers, weighted)
    stats = dist.CollectiveStats()
    ctx = SimMesh(workers).ctx(stats=stats, weights=weights)
    tparts = [torch.tensor(p) for p in parts]
    before = [t.clone() for t in tparts]
    got = ctx.pmean_flat(tparts, wire_dtype=WIRE)
    want, jstats = _reference_reduce(parts, workers, weights, "pmean_flat")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w.view(np.uint32))
    assert (stats.sizes, stats.itemsizes, stats.kinds) == (
        jstats.sizes, jstats.itemsizes, jstats.kinds) == ([sum(
            int(np.prod(s)) for s in SHAPES)], [2], ["reduce"])
    assert all(torch.equal(a, b) for a, b in zip(tparts, before))
    # psum on bfloat16 buffers
    got = [ctx.psum_data(t.to(torch.bfloat16)) for t in tparts]
    want, _ = _reference_reduce(parts, workers, weights, "psum")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # a plain float32 mean of the bfloat16 values differs from the fold
    if workers >= 3 and not weighted:
        x = tparts[3].to(torch.bfloat16)
        assert not torch.equal(x.float().mean(0).to(torch.bfloat16),
                               SimMesh(workers).ctx().backend.pmean(x))


def test_fold_leaves_input_and_in_place_gives_same_bits():
    x = torch.randn(5, 1000, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    w = torch.tensor([1.0, 0.0, 2.0, 0.5, 3.0])
    before = x.clone()
    s = dist.worker_sum(x)
    assert torch.equal(x, before) and s.data_ptr() != x.data_ptr()
    one = dist.worker_sum(x[:1])
    assert torch.equal(one, x[0]) and one.data_ptr() != x.data_ptr()
    plain = dist.stacked_weighted_mean(x, w)
    assert torch.equal(x, before)
    inplace = dist.stacked_weighted_mean(x.clone(), w, in_place=True)
    assert plain.dtype == torch.bfloat16 and torch.equal(plain, inplace)
    zero = dist.stacked_weighted_mean(x, torch.zeros(5))
    assert torch.equal(zero, torch.zeros_like(zero))
    # float32 keeps x.sum(0)
    y = torch.randn(5, 100)
    assert torch.equal(dist.worker_sum(y), y.sum(0))


# ---------------------------------------------------------------------------
# PowerSGD on the bfloat16 wire
# ---------------------------------------------------------------------------

PSHAPES = {"w1": (3, 24, 16), "w2": (20, 15), "w3": (24, 14), "b": (16,),
           "w4": (2, 9, 40)}
# The bfloat16 wire against the reference, whole step: the packages' P
# and Q differ by float32 rounding before the cast, which flips the
# bfloat16 rounding of an element now and then (2⁻⁸ relative); a flipped
# P element moves its column's orthogonalization and the Q built from it.
# So agg and Q within BF16_ATOL + BF16_RTOL·|x| (two bfloat16 ulps),
# and all but BF16_FLIPS of them within the float32 wire's 1e-5 / 1e-4.
# At these shapes no rounding flipped (seeds 5, 6, 7: Q bit-equal, agg
# within 2.4e-7); the rule is the one the card's runs take at full width.
BF16_ATOL, BF16_RTOL, BF16_FLIPS = 1e-3, 2.0**-7, 0.01


def _pspecs(mod):
    return {"w1": mod.MatrixSpec("matrix", 1), "w2": mod.MatrixSpec("matrix", 0),
            "w3": mod.MatrixSpec("matrix", 0), "b": mod.NONE,
            "w4": mod.MatrixSpec("matrix", 1)}


def _pdeltas(workers, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((workers,) + s).astype(np.float32)
            for k, s in PSHAPES.items()}


def _reference_step(deltas, q0, workers):
    sim, stats = JSimMesh(workers), jdist.CollectiveStats()
    cfg = jpsgd.PowerSGDConfig(rank=2, wire_dtype=WIRE)

    def worker(d, q):
        out = jpsgd.compress_aggregate(cfg, d, q, _pspecs(jmz), sim.ctx(stats=stats))
        return out.agg, out.state

    agg, q = sim.run(worker, in_axes=(0, None))(
        jax.tree_util.tree_map(jnp.asarray, deltas),
        jax.tree_util.tree_map(jnp.asarray, q0))
    first = lambda t: {k: None if v is None else np.asarray(v[0])
                       for k, v in t.items()}
    return first(agg), first(q), stats


def _q0(workers):
    shapes = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in PSHAPES.items()}
    q0 = jpsgd.init_state(jpsgd.PowerSGDConfig(rank=2), shapes, _pspecs(jmz),
                          jax.random.key(1))
    return {k: None if v is None else np.asarray(v) for k, v in q0.items()}


def test_powersgd_reduces_bit_equal_on_the_same_inputs(monkeypatch):
    """Each of the step's two reduces, fed the port's own pre-cast payloads
    (P slabs and the vector leaf, then Q slabs), gives the reference's
    reduce of the same payloads bit for bit."""
    workers = 4
    calls = []
    pmean_flat = dist.MeshCtx.pmean_flat

    def recording(self, parts, **kw):
        out = pmean_flat(self, parts, **kw)
        calls.append(([p.numpy().copy() for p in parts], [o.numpy() for o in out],
                      kw["wire_dtype"]))
        return out

    monkeypatch.setattr(dist.MeshCtx, "pmean_flat", recording)
    cfg = powersgd.PowerSGDConfig(rank=2, wire_dtype=WIRE)
    powersgd.compress_aggregate(cfg, bridge.to_torch(_pdeltas(workers)),
                                bridge.to_torch(_q0(workers)), _pspecs(mz),
                                SimMesh(workers).ctx())
    assert [c[2] for c in calls] == [WIRE, WIRE]
    for parts, got, _ in calls:
        want, _ = _reference_reduce(parts, workers, None, "pmean_flat")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def _flip_close(got, want, what):
    d = np.abs(got - want)
    assert np.all(d <= BF16_ATOL + BF16_RTOL * np.abs(want)), what
    assert (d > 1e-5 + 1e-4 * np.abs(want)).mean() <= BF16_FLIPS, what


def test_powersgd_step_matches_reference_flip_aware():
    workers = 4
    deltas, q0 = _pdeltas(workers, seed=5), _q0(workers)
    agg_r, q_r, stats_r = _reference_step(deltas, q0, workers)
    stats = dist.CollectiveStats()
    comp = compressors.make_compressor("powersgd", rank=2, wire_dtype=WIRE)
    out = comp.step(bridge.to_torch(deltas), bridge.to_torch(q0), _pspecs(mz),
                    SimMesh(workers).ctx(stats=stats))
    for k in PSHAPES:
        _flip_close(out.agg[k].numpy(), agg_r[k], k)
        if q_r[k] is not None:
            _flip_close(out.state[k].numpy(), q_r[k], k)
    assert stats.itemsizes == stats_r.itemsizes == [2, 2]
    assert stats.sizes == stats_r.sizes
    f32 = dist.CollectiveStats()
    compressors.make_compressor("powersgd", rank=2, wire_dtype="float32").step(
        bridge.to_torch(deltas), bridge.to_torch(q0), _pspecs(mz),
        SimMesh(workers).ctx(stats=f32))
    assert f32.sizes == stats.sizes and f32.itemsizes == [4, 4]
    assert stats.bytes_per_collective() == [b // 2 for b in f32.bytes_per_collective()]


# ---------------------------------------------------------------------------
# Top-K on the bfloat16 wire
# ---------------------------------------------------------------------------

def test_topk_bf16_wire_agg_is_the_decoded_payloads_mean():
    workers, n = 2, 40
    rng = np.random.default_rng(7)
    d = rng.standard_normal((workers, n, n)).astype(np.float32)
    stats = dist.CollectiveStats()
    comp = compressors.make_compressor("top_k", rank=2, wire_dtype=WIRE)
    assert comp.declared_budget() == (3, 1, 2)
    out = comp.step({"w": torch.tensor(d), "b": torch.tensor(d[:, 0])},
                    None, {"w": mz.MatrixSpec("matrix", 0), "b": mz.NONE},
                    SimMesh(workers).ctx(stats=stats))
    assert stats.kinds == ["reduce", "gather", "gather"]
    assert stats.itemsizes == [2, 2, 4]      # values bfloat16, indices int32
    b = stats.sizes[1]
    flat = torch.tensor(d).reshape(workers, -1)
    decs, own = [], []
    for row in flat:
        idx = torch.topk(row.abs(), b, sorted=True).indices
        assert idx.max() > 256
        vals = row[idx].to(torch.bfloat16).float()
        decs.append(torch.zeros(n * n).scatter_(0, idx, vals))
        own.append(torch.zeros(n * n).scatter_(0, idx, row[idx]))
    assert torch.equal(out.agg["w"].reshape(-1), torch.stack(decs).mean(0))
    # error feedback subtracts the worker's own selection, unrounded
    assert torch.equal(out.recon["w"].reshape(workers, -1), torch.stack(own))


# ---------------------------------------------------------------------------
# One-ulp sensitivity of the bfloat16 wire (python tests/test_torch_wire_bf16.py)
# ---------------------------------------------------------------------------

def _one_ulp(t):
    """Every float of the tree moved one ulp up."""
    from repro_torch import tree
    return tree.map(lambda x: torch.nextafter(x, torch.full_like(x, np.inf)), t)


def _llama_one_ulp(wire):
    """Reduced Llama-3-8B at W = 2 (2 sequences of 128 tokens a worker,
    ``TrainHyper(q_chunk=64, warmup_steps=2)``, PowerSGD rank 2), 3 steps
    on the CPU from one initial state and from it moved one ulp: the
    largest parameter distance between the two runs and how many
    parameters lie beyond 1e-5 and beyond 1e-4."""
    from repro_torch import tree
    from repro_torch.configs import llama3_8b
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch import train

    cfg, sim = llama3_8b.reduced_config(), SimMesh(2)
    hyper = train.TrainHyper(q_chunk=64, warmup_steps=2)
    step, init = train.make_sim_train_step(
        cfg, sim, hyper, device="cpu",
        compressor=compressors.make_compressor("powersgd", rank=2, wire_dtype=wire))
    finals = []
    for move in (False, True):
        params, ef = init(torch.Generator().manual_seed(0))
        if move:
            params = _one_ulp(params)
        data = MarkovLM(vocab=cfg.vocab_size, seed=0, order=1)
        for i in range(3):
            toks = torch.tensor(data.sample(4, 128, step=i))
            params, ef, _ = step(params, ef, sim.shard(
                {"tokens": toks[:, :-1], "labels": toks[:, 1:]}))
        finals.append(tree.leaves(params))
    d = [(a - b).abs() for a, b in zip(*finals)]
    return {"max_abs_param_diff": max(x.max().item() for x in d),
            "beyond_1e-5": sum(int((x > 1e-5).sum()) for x in d),
            "beyond_1e-4": sum(int((x > 1e-4).sum()) for x in d),
            "params": sum(x.numel() for x in d)}


def _tuned_lm_one_ulp(steps, wire):
    """The benchmark LM under the autotuner's plan at half of rank 4's bits
    (the paper's 10 Gbit/s NCCL cluster; the plan picks the bfloat16
    wire), its ranks sent on ``wire``, ``steps`` steps on the CPU from one
    initial state and from its parameters moved one ulp: the relative
    eval_loss distance."""
    import dataclasses

    from repro_torch.bench import common
    from repro_torch.core import autotune
    from repro_torch.models import model

    spec = common.LMSpec(steps=steps)
    cfg = common._make_cfg(spec)
    shapes, specs = model.init(cfg, None, device="meta"), model.mspecs(cfg)
    plan = autotune.autotune(
        shapes, specs, workers=spec.workers,
        bits_budget=powersgd.compressed_floats_total(shapes, specs, 4) * 32 // 2,
        hw=autotune.HardwareModel.from_backend("nccl_10gbit"))
    assert plan.wire_dtype == WIRE
    comp = autotune.make_tuned_compressor(dataclasses.replace(plan, wire_dtype=wire))
    gen = torch.Generator().manual_seed(spec.seed)
    params = model.init(cfg, gen, device="cpu")
    comp_state = comp.init(params, specs, gen)
    losses = [common.train_lm(
        comp, spec, device="cpu", params=p, comp_state=comp_state,
        init_comp_transform=lambda cs: autotune.apply_plan(plan, cs, shapes, specs)
    )["eval_loss"] for p in (params, _one_ulp(params))]
    return {"wire": wire, "eval_loss": losses,
            "rel_eval_loss_diff": abs(losses[1] - losses[0]) / abs(losses[0])}


if __name__ == "__main__":
    import json

    torch.set_num_threads(1)
    for wire in ("float32", WIRE):
        print(json.dumps({"run": "reduced Llama-3-8B, W = 2, 3 steps, one ulp",
                          "wire": wire, **_llama_one_ulp(wire)}), flush=True)
    for wire in ("float32", WIRE):
        for steps in (5, 10):
            print(json.dumps({"run": "tuned benchmark LM, W = 4, one ulp",
                              "steps": steps, **_tuned_lm_one_ulp(steps, wire)}),
                  flush=True)
