"""EF-Top-K over the fused gather wire: the port against the JAX package on
the same numpy inputs.

* Flat wire plans for the quantized wires equal the reference's, slot for
  slot.
* Quantized payloads, scales, unpacked and dequantized buffers are
  bit-exact (integer codes and single IEEE float32 operations on identical
  inputs).
* Top-K aggregates and reconstructions, at W ∈ {1, 4} workers and wire
  dtypes ``auto`` and ``int4``: reconstructions bit-exact (a scatter of the
  worker's own values), aggregates within atol 1e-6 / rtol 1e-6 (a mean of
  W decodes summed in another order).  Inputs are continuous random draws,
  so the selections have no ties.
* The ``CollectiveStats`` records are equal: kinds, sizes, fractional
  itemsizes, fanouts, sidecar overheads.
* 3 training steps of ``make_sim_train_step`` with ``top_k`` on the int4
  wire, reduced Llama-3-8B, 4 simulated workers, against
  ``repro.launch.train.make_sim_train_step`` from the same parameters: see
  :func:`test_three_train_steps_match_reference` for the tolerance and its
  reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jllama
from repro.core import compressors as jcomp
from repro.core import dist as jdist
from repro.core import matrixize as jmz
from repro.core.simmesh import SimMesh as JSimMesh
from repro.launch import train as jtrain
from repro_torch import bridge, tree
from repro_torch.configs import llama3_8b
from repro_torch.core import compressors, dist, engine, matrixize as mz
from repro_torch.core.error_feedback import EFState
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.kernels import lowrank, quant
from repro_torch.launch import train


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = RTOL = 1e-6
KEY = jax.random.key(0)
SHAPES = {"w1": (24, 16), "conv": (8, 4, 3, 3), "stack": (3, 12, 6),
          "bias": (7,), "scale": (5,)}


def _specs(mod):
    return {"w1": mod.MatrixSpec("matrix", 0), "conv": mod.MatrixSpec("conv", 0),
            "stack": mod.MatrixSpec("matrix", 1), "bias": mod.NONE,
            "scale": mod.NONE}


def _deltas(workers, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((workers,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _records(stats):
    return (stats.kinds, stats.sizes, stats.itemsizes, stats.fanouts,
            stats.overheads, stats.bytes_per_collective())


# ---------------------------------------------------------------------------
# flat wire plans and quantized payload chunks
# ---------------------------------------------------------------------------

def _payload_parts(seed=0):
    """A Top-K-like payload list: float values and int32 indices per leaf,
    odd sizes, an all-zero slot and a slot of exact half-way values."""
    rng = np.random.default_rng(seed)
    vals = [rng.standard_normal(n).astype(np.float32) for n in (33, 1, 10)]
    vals[1][:] = 0.0
    vals[2] = (np.arange(10, dtype=np.float32) - 4.5) / 7 * 2
    parts = []
    for v in vals:
        parts += [v, rng.integers(0, 1000, v.size).astype(np.int32)]
    return parts


def _chunk_tuple(c):
    slots = tuple((s.index, s.offset, s.size, tuple(s.shape),
                   str(s.dtype).removeprefix("torch.") if isinstance(s.dtype, torch.dtype)
                   else np.dtype(s.dtype).name) for s in c.slots)
    wd = (str(c.wire_dtype).removeprefix("torch.") if isinstance(c.wire_dtype, torch.dtype)
          else np.dtype(c.wire_dtype).name)
    return (wd, c.quant, slots, c.wire_itemsize, c.overhead_bytes, c.wire_bytes)


@pytest.mark.parametrize("cap", [None, 120])
@pytest.mark.parametrize("wire_dtype", ["int8", "int4"])
def test_plan_flat_quant_layouts_match_reference(wire_dtype, cap):
    parts = _payload_parts()
    jplan = jmz.plan_flat([jnp.asarray(p) for p in parts], wire_dtype=wire_dtype,
                          max_chunk_bytes=cap)
    plan = mz.plan_flat([torch.tensor(p) for p in parts], wire_dtype=wire_dtype,
                        max_chunk_bytes=cap)
    assert [_chunk_tuple(c) for c in plan.chunks] == [
        _chunk_tuple(c) for c in jplan.chunks]
    assert plan.total_wire_bytes == jplan.total_wire_bytes
    qchunks = [c for c in plan.chunks if c.quant]
    jq = [c for c in jplan.chunks if c.quant]
    assert [mz.quant_slot_sizes(c) for c in qchunks] == [
        jmz.quant_slot_sizes(c) for c in jq]


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("wire_dtype", ["int8", "int4"])
def test_quant_chunk_payloads_bitexact(wire_dtype, workers):
    """quant_pack_flat (W workers in one call) equals the reference worker
    by worker; quant_unpack_flat of the gathered (W, bytes) payload and
    quant_dequant_flat equal the reference's bit for bit."""
    per_worker = [_payload_parts(seed=w) for w in range(workers)]
    stacked = [torch.tensor(np.stack(ps)) for ps in zip(*per_worker)]
    chunk = next(c for c in mz.plan_flat(stacked, wire_dtype=wire_dtype,
                                         lead=1).chunks if c.quant)
    jchunk = next(c for c in jmz.plan_flat(
        [jnp.asarray(p) for p in per_worker[0]], wire_dtype=wire_dtype).chunks
        if c.quant)
    payload, scales = mz.quant_pack_flat(chunk, stacked, lead=1)
    # eager, not jitted: under jit XLA rewrites the scale's division by the
    # constant qmax into a product with its rounded reciprocal, which moves
    # some scales by one ulp (ROADMAP queue C)
    jpay, jsc, jdeq = [], [], []
    for ps in per_worker:
        jp = [jnp.asarray(p) for p in ps]
        p_, s_ = jmz.quant_pack_flat(jchunk, jp)
        jpay.append(np.asarray(p_))
        jsc.append(np.asarray(s_))
        jdeq.append(np.asarray(jmz.quant_dequant_flat(jchunk, jp)))
    np.testing.assert_array_equal(payload.numpy(), np.stack(jpay))
    assert payload.dtype == (torch.uint8 if wire_dtype == "int4" else torch.int8)
    np.testing.assert_array_equal(scales.numpy(), np.stack(jsc))
    np.testing.assert_array_equal(
        mz.quant_dequant_flat(chunk, stacked, lead=1).numpy(), np.stack(jdeq))
    got = mz.quant_unpack_flat(chunk, payload, scales, leading=(workers,))
    want = jmz.quant_unpack_flat(jchunk, jnp.asarray(np.stack(jpay)),
                                 jnp.asarray(np.stack(jsc)), leading=(workers,))
    assert sorted(got) == sorted(want)
    for i in got:
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))


# ---------------------------------------------------------------------------
# Top-K through the engine
# ---------------------------------------------------------------------------

def _reference_step(comp, deltas, workers, stats):
    specs = _specs(jmz)
    jd = jax.tree_util.tree_map(jnp.asarray, deltas)
    sim = JSimMesh(workers)

    def one(g):
        out = comp.step(g, None, specs, ctx=sim.ctx(stats=stats), key=KEY)
        return out.agg, out.recon, out.bits_per_worker

    agg, recon, bits = jax.jit(sim.run(one))(jd)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return to_np(agg), to_np(recon), int(bits[0])


def _port_step(comp, deltas, workers, stats):
    out = comp.step(bridge.to_torch(deltas), None, _specs(mz),
                    SimMesh(workers).ctx(stats=stats))
    return bridge.to_numpy(out.agg), bridge.to_numpy(out.recon), out.bits_per_worker


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("wire_dtype", ["auto", "int4"])
def test_topk_matches_reference(wire_dtype, workers):
    deltas = _deltas(workers)
    jstats, stats = jdist.CollectiveStats(), dist.CollectiveStats()
    agg_r, recon_r, bits_r = _reference_step(
        jcomp.make_compressor("top_k", rank=2, wire_dtype=wire_dtype),
        deltas, workers, jstats)
    agg, recon, bits = _port_step(
        compressors.make_compressor("top_k", rank=2, wire_dtype=wire_dtype),
        deltas, workers, stats)
    for k in SHAPES:
        np.testing.assert_allclose(agg[k], agg_r[k][0], atol=ATOL, rtol=RTOL,
                                   err_msg=k)
        np.testing.assert_array_equal(recon[k], recon_r[k], err_msg=k)
    assert bits == bits_r
    assert _records(stats) == _records(jstats)
    assert (stats.data_collectives, stats.reduce_collectives,
            stats.gather_collectives) == (3, 1, 2)


def test_topk_single_context_matches_reference():
    """Outside any data axis the gather hands back a worker dim of 1."""
    deltas = {k: v[0] for k, v in _deltas(1, seed=5).items()}
    jstats, stats = jdist.CollectiveStats(), dist.CollectiveStats()
    jc = jcomp.make_compressor("top_k", rank=2, wire_dtype="int4")
    agg_r, recon_r = jax.jit(lambda d: dataclasses.astuple(jc.step(
        d, None, _specs(jmz), ctx=jdist.MeshCtx(stats=jstats), key=KEY))[:2])(
        jax.tree_util.tree_map(jnp.asarray, deltas))
    out = compressors.make_compressor("top_k", rank=2, wire_dtype="int4").step(
        bridge.to_torch(deltas), None, _specs(mz), dist.MeshCtx(stats=stats))
    for k in SHAPES:
        np.testing.assert_allclose(out.agg[k].numpy(), np.asarray(agg_r[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
        np.testing.assert_array_equal(out.recon[k].numpy(),
                                      np.asarray(recon_r[k]), err_msg=k)
    assert _records(stats) == _records(jstats)


@pytest.mark.parametrize("wire_dtype", ["auto", "float32", "int8", "int4"])
def test_topk_declared_budget(wire_dtype):
    """Equal to the reference's budget, except on the float32 wire: there
    the port keeps the int32 indices in a chunk of their own (declared
    divergence, ``matrixize.plan_flat``), one gather more than the
    reference, which casts them into the float chunk."""
    comp = compressors.make_compressor("top_k", rank=2, wire_dtype=wire_dtype)
    want = jcomp.make_compressor("top_k", rank=2,
                                 wire_dtype=wire_dtype).declared_budget()
    if wire_dtype == "float32":
        assert want == (2, 1, 1)
        assert comp.declared_budget() == (3, 1, 2)
    else:
        assert comp.declared_budget() == want
    if wire_dtype in ("auto", "int4"):
        assert want == (3, 1, 2)   # tests/sim/test_zoo_conformance.py ZOO_BUDGETS


def test_plan_flat_float32_keeps_integer_chunk():
    """Under the float32 wire float parts are cast into one chunk and int32
    parts keep an exact chunk of their own, in first-appearance order."""
    parts = [torch.zeros(5, dtype=torch.float64), torch.zeros(3, dtype=torch.int32),
             torch.zeros(2), torch.zeros(4, dtype=torch.int32)]
    plan = mz.plan_flat(parts, wire_dtype="float32")
    assert [(c.wire_dtype, [s.index for s in c.slots]) for c in plan.chunks] == [
        (torch.float32, [0, 2]), (torch.int32, [1, 3])]
    buf = mz.pack_flat(plan.chunks[1], [None, torch.tensor([2**24 + 1, 7, -3],
                                                           dtype=torch.int32),
                                        None, torch.arange(4, dtype=torch.int32)])
    assert buf.dtype == torch.int32 and buf[0].item() == 2**24 + 1


def test_topk_float32_wire_large_leaf_agg_equals_recon():
    """One 4200 × 4200 leaf (17.6 M entries, more than 2²⁴) at rank 1: the
    8,400 selected coordinates sit at odd indices above 2²⁴, where float32
    cannot hold an index exactly.  On one worker the aggregate must equal
    the worker's own reconstruction, every value at its index."""
    n, b = 4200, 8400
    rng = np.random.default_rng(0)
    delta = rng.random(n * n, dtype=np.float32)
    idx = 2**24 + 1 + 2 * rng.choice((n * n - 2**24 - 1) // 2, b, replace=False)
    delta[idx] = 10.0 + rng.random(b, dtype=np.float32)
    deltas = {"w": torch.tensor(delta.reshape(1, n, n))}
    stats = dist.CollectiveStats()
    out = compressors.make_compressor("top_k", rank=1, wire_dtype="float32").step(
        deltas, None, {"w": mz.MatrixSpec("matrix", 0)},
        SimMesh(1).ctx(stats=stats))
    agg, recon = out.agg["w"].reshape(-1), out.recon["w"].reshape(-1)
    assert torch.equal(agg, recon)
    assert torch.equal(torch.nonzero(agg).squeeze(1),
                       torch.tensor(np.sort(idx), dtype=torch.long))
    assert torch.equal(agg[idx], torch.tensor(delta[idx]))
    assert stats.kinds == ["gather", "gather"]
    assert stats.itemsizes == [4, 4]


class _Identity(compressors.Compressor):
    """Every compressed leaf is its own payload (the reference's
    IdentityCompressor on the matrix leaves): drives run_step's reduce
    branch."""

    def encode_leaf(self, path, g, q, spec, lead, seed):
        if not spec.is_compressed():
            return None
        return engine.Encoded(payload=(g,),
                              bits=mz.uncompressed_floats(g.shape[len(lead):]) * 32)

    def decode_leaf(self, enc, payload, lead):
        return payload[0]


class _JIdentity(jcomp.IdentityCompressor):
    def encode_leaf(self, path, g, q, spec, key):
        return super().encode_leaf(path, g, q, spec, key) if spec.is_compressed() else None


@pytest.mark.parametrize("wire_dtype", ["auto", "int4"])
def test_run_step_reduce_branch_matches_reference(wire_dtype):
    """A linear scheme's payloads ride one fused reduce with the
    uncompressed leaves; under int4 each worker's slot is quantized and
    dequantized before the mean (bit-exact per worker, so only the mean's
    order differs)."""
    workers = 4
    deltas = _deltas(workers, seed=3)
    jstats, stats = jdist.CollectiveStats(), dist.CollectiveStats()
    agg_r, recon_r, bits_r = _reference_step(
        _JIdentity(wire_dtype=wire_dtype), deltas, workers, jstats)
    agg, recon, bits = _port_step(_Identity(wire_dtype=wire_dtype), deltas,
                                  workers, stats)
    for k in SHAPES:
        np.testing.assert_allclose(agg[k], agg_r[k][0], atol=ATOL, rtol=RTOL,
                                   err_msg=k)
        np.testing.assert_array_equal(recon[k], recon_r[k], err_msg=k)
    assert bits == bits_r
    assert _records(stats) == _records(jstats)


def test_unported_compressor_options_raise():
    """The rest of the zoo and ``transport="per_leaf"`` (ROADMAP queue A,
    items 4 and 5) are ported: every reference name builds, an unknown one
    raises ``ValueError`` as in the reference, and Top-K's per-leaf path
    matches the reference's.  Scenario weights (item 6) are ported too: a
    weighted gather combine returns ``Σ wᵢxᵢ / Σ wᵢ``."""
    for name in ("sign_norm", "random_k", "spectral_atomo", "exact_rank_k"):
        assert (compressors.make_compressor(name).name
                == jcomp.make_compressor(name).name)
    with pytest.raises(ValueError, match="unknown compressor"):
        compressors.make_compressor("signum")
    deltas = _deltas(4)
    jstats, stats = jdist.CollectiveStats(), dist.CollectiveStats()
    agg_r, recon_r, bits_r = _reference_step(
        jcomp.TopK(rank=2, transport="per_leaf"), deltas, 4, jstats)
    agg, recon, bits = _port_step(compressors.TopK(transport="per_leaf"),
                                  deltas, 4, stats)
    for k in SHAPES:
        np.testing.assert_allclose(agg[k], agg_r[k][0], atol=ATOL, rtol=RTOL,
                                   err_msg=k)
        np.testing.assert_array_equal(recon[k], recon_r[k], err_msg=k)
    assert bits == bits_r
    assert _records(stats) == _records(jstats)
    stacked = torch.tensor([[1.0, 2.0, 3.0], [5.0, 6.0, 7.0]])
    got = engine.Transport.combine_mean(stacked, torch.tensor([3.0, 1.0]))
    assert torch.equal(got, torch.tensor([2.0, 3.0, 4.0]))


# ---------------------------------------------------------------------------
# the slice end to end: 3 training steps
# ---------------------------------------------------------------------------

W, STEPS, BATCH, SEQ = 4, 3, 8, 32


def _batches(vocab):
    data = MarkovLM(vocab=vocab, seed=0, order=1)
    for i in range(STEPS):
        toks = data.sample(BATCH, SEQ, step=i)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@pytest.fixture(scope="module")
def reference_run():
    cfg = jllama.reduced_config()
    sim = JSimMesh(W)
    hyper = jtrain.TrainHyper(remat=False, q_chunk=16, warmup_steps=2)
    stats = jdist.CollectiveStats()
    comp = jcomp.make_compressor("top_k", rank=2, wire_dtype="int4")
    step, init = jtrain.make_sim_train_step(cfg, sim, hyper, compressor=comp,
                                            stats=stats)
    params, ef = init(jax.random.key(0))
    params0 = jax.tree_util.tree_map(lambda x: np.asarray(x[0]), params)
    losses = []
    for i, b in enumerate(_batches(cfg.vocab_size)):
        params, ef, m = step(params, ef, sim.shard(b), jax.random.key(i))
        losses.append(float(m["lm_loss"][0]))
    final = jax.tree_util.tree_map(lambda x: np.asarray(x[0]), params)
    return params0, losses, final, stats


def test_three_train_steps_match_reference(reference_run):
    """Tolerance: per-step loss rtol 1e-5, parameters atol 2e-6, the
    float32-rounding tolerances of the PowerSGD slice's 5-step test.

    The packages' gradients differ by float32 rounding (~1e-7 relative).
    Measured here: losses within 1.3e-7 relative, parameters within
    1.2e-7.  Such a difference could move a coordinate across the top-k
    boundary or an int4 code across a rounding boundary; either would move
    one element of the update by lr·(1+λ) times a quantization step, far
    above 2e-6.  None happens on these inputs, and the tolerance is not
    widened to hide one: a flip fails this test."""
    params0, ref_losses, ref_params, jstats = reference_run
    cfg = llama3_8b.reduced_config()
    sim = SimMesh(W)
    stats = dist.CollectiveStats()
    comp = compressors.make_compressor("top_k", rank=2, wire_dtype="int4")
    step, _ = train.make_sim_train_step(
        cfg, sim, train.TrainHyper(q_chunk=16, warmup_steps=2),
        compressor=comp, stats=stats, device="cpu")
    params = bridge.to_torch(params0)
    ef = EFState(error=tree.map(lambda p: torch.zeros((W,) + tuple(p.shape)), params),
                 momentum=tree.map(torch.zeros_like, params), comp=None)
    lowrank.reset_launches()
    quant.reset_launches()
    losses = []
    for b in _batches(cfg.vocab_size):
        params, ef, m = step(params, ef, sim.shard(
            {k: torch.tensor(v) for k, v in b.items()}))
        losses.append(m["lm_loss"].item())
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for (path, got), want in zip(tree.items(bridge.to_numpy(params)),
                                 tree.leaves(ref_params)):
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0, err_msg=str(path))
    assert ef.step == STEPS and ef.comp is None
    # one reduce (norm leaves) + two gathers (int4 codes, int32 indices) per
    # step, recorded as the reference records its one trace
    assert (stats.reduce_collectives, stats.gather_collectives) == (STEPS, 2 * STEPS)
    per_step = [r[:3] for r in zip(*_records(stats)[:5])]
    assert per_step == [r[:3] for r in zip(*_records(jstats)[:5])] * STEPS
    # the CPU path never launches a CUDA kernel
    assert lowrank.LAUNCHES == {"lowrank_project": 0, "lowrank_backproject": 0}
    assert quant.LAUNCHES == {"nibble_pack": 0, "nibble_unpack": 0}


def test_hyper_wire_dtype_reaches_default_compressor():
    """``TrainHyper.wire_dtype`` sets the default PowerSGD's wire: its two
    reduces per step travel as int4 codes with a scale per slot, recorded
    at 0.5 B per element."""
    cfg = llama3_8b.reduced_config()
    sim = SimMesh(2)
    stats = dist.CollectiveStats()
    step, init = train.make_sim_train_step(
        cfg, sim, train.TrainHyper(q_chunk=16, wire_dtype="int4"),
        stats=stats, device="cpu")
    params, ef = init(torch.Generator().manual_seed(0))
    b = next(_batches(cfg.vocab_size))
    params, ef, m = step(params, ef, sim.shard(
        {k: torch.tensor(v[:4]) for k, v in b.items()}))
    assert np.isfinite(m["lm_loss"].item())
    assert stats.kinds == ["reduce", "reduce"]
    assert stats.itemsizes == [0.5, 0.5]
    assert all(o > 0 for o in stats.overheads)
