"""Save → restore → continue on reduced Llama-3-8B: the port's
``repro_torch.checkpoint.train_state`` through ``make_sim_train_step``, and
envelopes crossing between the port and the JAX package.

"Kill" is a rebuild from nothing (new compressor, new step, new template
drawn from another seed, new controller) restoring only from the envelope's
bytes, as a new process would.

* Port save → restore bit-exact (losses and parameters) at W ∈ {1, 4} at a
  fixed rank, at W = 4 mid-staircase with the ``RankController`` (its
  growth after the restore draws the same columns), and on the bfloat16 and
  int4 wires.  A mismatched wire dtype is refused, a truncated envelope
  rejected naming its file.
* Elastic W = 4 → 2: the restored error buffers equal the JAX package's
  own rescale of the same envelope, and ``meta["ef_rescale"]`` agrees.
* Across packages, at W = 2 under the tolerances of
  ``tests/test_torch_train.py`` (losses rtol 1e-5, parameters atol 2e-6):
  the reference saves at step 4, the port restores and continues to step 8
  against the reference's uninterrupted run; the port runs steps 0–3 from
  the reference's start (``bridge.to_torch``) and saves, and the reference
  restores it and continues against the same run.
* One-step staleness (``TrainHyper(staleness="one_step")``, the reference
  suite's lr 0.05 and momentum 0; ``tests/sim/test_resume.py``): a save in
  mid pipeline, with a nonzero in-flight aggregate, resumes bit for bit
  (losses, parameters, the in-flight tree) and needs no splice; a v1
  envelope without the record zero-fills the in-flight tree of a one-step
  template (``meta["inflight"] == "zero_filled"``) and trains on; a
  one-step envelope restored into a synchronous template drops it
  (``"dropped"``).  Across packages both ways as above, the restored
  in-flight tree bit-equal to the saved one.

Declared divergences: the base key crosses as ``jax.random.key(seed)``'s
data, but the packages draw different streams from it (PowerSGD's
warm-started steps draw nothing); a controller crossing packages keeps
rank, ema and history, not its column stream
(``tests/test_torch_checkpoint.py::test_controller_state_dict_crosses_both_ways``).
"""

import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import llama3_8b as jllama
from repro.core.simmesh import SimMesh as JSimMesh
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.launch import train as jtrain
from repro_torch import bridge, tree
from repro_torch import checkpoint as ckpt
from repro_torch.configs import llama3_8b
from repro_torch.core import error_feedback
from repro_torch.core.compressors import PowerSGDCompressor
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


BATCH, SEQ = 8, 32
STEPS, CKPT_AT = 8, 4
KEY = jax.random.key(0)


# the one-step runs train at the reference suite's operating point
STALE = {"lr": 0.05, "momentum": 0.0}


def build(workers, schedule=None, wire_dtype="auto", staleness="none"):
    """A new "process": compressor, step and controller."""
    cfg = llama3_8b.reduced_config()
    hyper = train.TrainHyper(q_chunk=32, warmup_steps=5, weight_decay=0.0,
                             wire_dtype=wire_dtype, staleness=staleness,
                             **(STALE if staleness == "one_step" else {}))
    comp = PowerSGDCompressor(rank=2, rank_schedule=schedule,
                              wire_dtype=wire_dtype,
                              pipeline=staleness == "one_step")
    sim = SimMesh(workers)
    step, init = train.make_sim_train_step(cfg, sim, hyper, compressor=comp,
                                           device="cpu")
    return cfg, sim, step, init, comp.controller() if schedule else None


def run(cfg, sim, step, params, ef, ctl, start, stop):
    """Steps [start, stop), batch i = MarkovLM's draw i."""
    data = MarkovLM(vocab=cfg.vocab_size, seed=0)
    losses = []
    for i in range(start, stop):
        if ctl is not None:
            comp, changed = ctl.update(ef.comp, i)
            if changed:
                ef = error_feedback.replace_comp(ef, comp)
        toks = torch.from_numpy(data.sample(BATCH, SEQ, step=i))
        batch = sim.shard({"tokens": toks[:, :-1], "labels": toks[:, 1:].contiguous()})
        params, ef, m = step(params, ef, batch, seed=0)
        losses.append(m["lm_loss"].item())
    return params, ef, losses


def save_at(directory, sim, params, ef, ctl=None, wire_dtype="auto"):
    p, e = ckpt.canonicalize_sim(sim, params, ef)
    return ckpt.save_train_state(
        str(directory), ckpt.TrainState(params=p, ef=e, seed=0, data_step=e.step),
        controller=ctl, extra_meta={"wire_dtype": wire_dtype})


def restore_into(directory, workers, schedule=None, wire_dtype="auto",
                 staleness="none"):
    cfg, sim, step, init, ctl = build(workers, schedule, wire_dtype, staleness)
    p0, e0 = init(torch.Generator().manual_seed(99))   # not the saved values
    if e0.inflight is not None:
        tree.map(lambda x: x.fill_(1.0), e0.inflight)   # not zeros either
    state, meta = ckpt.restore_train_state(
        str(directory), ckpt.TrainState(*ckpt.canonicalize_sim(sim, p0, e0)))
    if ctl is not None and meta.get("controller"):
        ctl.load_state_dict(meta["controller"])
    params, ef = ckpt.replicate_sim(sim, state.params, state.ef)
    return cfg, sim, step, ctl, params, ef, meta


def assert_bit_equal(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)


CASES = {"W1": (1, None, "auto"), "W4": (4, None, "auto"),
         "W4-staircase": (4, "1@0,2@3,4@6", "auto"),
         "W4-bfloat16": (4, None, "bfloat16"), "W4-int4": (4, None, "int4")}


@pytest.mark.parametrize("case", list(CASES))
def test_resume_bit_exact(tmp_path, case):
    """save → kill → resume: losses and final parameters bit for bit equal
    to the uninterrupted run (mid-staircase: the rank moved 1 → 2 before
    the save, the growth to 4 comes after, from the restored controller)."""
    w, schedule, wire = CASES[case]
    cfg, sim, step, init, ctl = build(w, schedule, wire)
    params, ef = init(torch.Generator().manual_seed(0))
    params, ef, head = run(cfg, sim, step, params, ef, ctl, 0, CKPT_AT)
    save_at(tmp_path, sim, params, ef, ctl, wire)
    saved_rank = ctl.rank if ctl else None
    params, ef, tail = run(cfg, sim, step, params, ef, ctl, CKPT_AT, STEPS)
    history = ctl and list(ctl.history)

    cfg, sim, step, ctl2, p2, e2, meta = restore_into(tmp_path, w, schedule, wire)
    assert meta["workers"] == w and e2.step == CKPT_AT
    assert meta["ef_rescale"] == {"from": w, "to": w, "path": "identity"}
    if schedule:
        assert ctl2.rank == saved_rank == 2
        assert {q.shape[-1] for q in tree.leaves(e2.comp) if q is not None} == {2}
    p2, e2, tail2 = run(cfg, sim, step, p2, e2, ctl2, CKPT_AT, STEPS)
    assert tail2 == tail
    assert_bit_equal(p2, params)
    assert_bit_equal(e2.momentum, ef.momentum)
    assert_bit_equal(e2.error, ef.error)
    if schedule:
        assert ctl2.history == history == [(0, 1), (3, 2), (6, 4)]


def test_mismatched_wire_and_truncation_rejected(tmp_path):
    cfg, sim, step, init, _ = build(1, wire_dtype="int4")
    params, ef = init(torch.Generator().manual_seed(0))
    params, ef, _ = run(cfg, sim, step, params, ef, None, 0, 1)
    path = save_at(tmp_path, sim, params, ef, wire_dtype="int4")
    meta = ckpt.checkpoint_meta(str(tmp_path))
    with pytest.raises(SystemExit) as exc:
        train.check_wire_dtype_meta(meta, "float32")
    assert "'float32'" in str(exc.value) and "'int4'" in str(exc.value)
    train.check_wire_dtype_meta(meta, "int4")
    train.check_wire_dtype_meta({}, "auto")
    with pytest.raises(SystemExit):
        train.check_wire_dtype_meta({}, "int8")
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) - len(raw) // 3])
    with pytest.raises(ckpt.CheckpointError, match="ckpt_0000000001.msgpack"):
        restore_into(tmp_path, 1, wire_dtype="int4")


# ---------------------------------------------------------------------------
# the reference's runs
# ---------------------------------------------------------------------------

def jbuild(workers, staleness="none"):
    cfg = jllama.reduced_config()
    hyper = jtrain.TrainHyper(q_chunk=32, warmup_steps=5, remat=False,
                              weight_decay=0.0, staleness=staleness,
                              **(STALE if staleness == "one_step" else {}))
    sim = JSimMesh(workers)
    step, init = jtrain.make_sim_train_step(cfg, sim, hyper)
    return cfg, sim, step, init


def jrun(cfg, sim, step, params, ef, start, stop):
    data = JMarkovLM(vocab=cfg.vocab_size, seed=0)
    losses = []
    for i in range(start, stop):
        toks = data.sample(BATCH, SEQ, step=i)
        b = sim.shard({"tokens": jnp.asarray(toks[:, :-1]),
                       "labels": jnp.asarray(toks[:, 1:].copy())})
        params, ef, met = step(params, ef, b, KEY)
        losses.append(float(met["lm_loss"][0]))
    return params, ef, losses


def jfirst(t):
    return jax.tree_util.tree_map(lambda x: None if x is None else np.array(x[0]),
                                  t, is_leaf=lambda x: x is None)


def jsave(directory, sim, params, ef):
    p, e = jckpt.canonicalize_sim(sim, params, ef)
    return jckpt.save_train_state(
        str(directory), jckpt.TrainState(params=p, ef=e, key=KEY,
                                         data_step=jnp.asarray(e.step)),
        extra_meta={"wire_dtype": "auto"})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference at W = 2: its start, its uninterrupted 8 steps (losses
    and final parameters) and its envelope at step 4 (saved on the way)."""
    directory = tmp_path_factory.mktemp("ref_ckpt")
    cfg, sim, step, init = jbuild(2)
    params, ef = init(KEY)
    start = (jfirst(params), jfirst(ef.comp))
    params, ef, head = jrun(cfg, sim, step, params, ef, 0, CKPT_AT)
    jsave(directory, sim, params, ef)
    params, ef, tail = jrun(cfg, sim, step, params, ef, CKPT_AT, STEPS)
    return {"dir": directory, "start": start, "losses": head + tail,
            "params": jfirst(params), "jax": (cfg, sim, step, init)}


def hold(losses, params_np, ref_losses, ref_params):
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for (path, got), want in zip(tree.items(params_np), tree.leaves(ref_params)):
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0, err_msg=str(path))


def test_reference_envelope_resumes_in_the_port(reference):
    cfg, sim, step, ctl, params, ef, meta = restore_into(reference["dir"], 2)
    assert meta["workers"] == 2 and ef.step == CKPT_AT
    assert meta["ef_rescale"]["path"] == "identity"
    params, ef, tail = run(cfg, sim, step, params, ef, None, CKPT_AT, STEPS)
    hold(tail, bridge.to_numpy(params), reference["losses"][CKPT_AT:],
         reference["params"])


def test_port_envelope_resumes_in_the_reference(reference, tmp_path):
    params0, q0 = reference["start"]
    cfg, sim, step, init, _ = build(2)
    params = bridge.to_torch(params0)
    ef = error_feedback.EFState(
        error=tree.map(lambda p: torch.zeros((2,) + tuple(p.shape)), params),
        momentum=tree.map(torch.zeros_like, params), comp=bridge.to_torch(q0))
    params, ef, head = run(cfg, sim, step, params, ef, None, 0, CKPT_AT)
    np.testing.assert_allclose(head, reference["losses"][:CKPT_AT], rtol=1e-5)
    save_at(tmp_path, sim, params, ef)

    jcfg, jsim, jstep, jinit = reference["jax"]
    p0, e0 = jinit(jax.random.key(5))
    template = jckpt.TrainState(*jckpt.canonicalize_sim(jsim, p0, e0), key=KEY,
                                data_step=jnp.zeros((), jnp.int32))
    state, meta = jckpt.restore_train_state(str(tmp_path), template)
    assert meta["workers"] == 2 and int(state.ef.step) == CKPT_AT
    np.testing.assert_array_equal(jax.random.key_data(state.key),
                                  jax.random.key_data(KEY))
    jp, je = jckpt.replicate_sim(jsim, state.params, state.ef)
    jp, je, tail = jrun(jcfg, jsim, jstep, jp, je, CKPT_AT, STEPS)
    hold(tail, jfirst(jp), reference["losses"][CKPT_AT:], reference["params"])


def test_elastic_4_to_2_matches_the_reference_rescale(tmp_path):
    cfg, sim, step, init, _ = build(4)
    params, ef = init(torch.Generator().manual_seed(0))
    params, ef, _ = run(cfg, sim, step, params, ef, None, 0, 2)
    save_at(tmp_path, sim, params, ef)
    cfg, sim, step, _, p2, e2, meta = restore_into(tmp_path, 2)
    assert meta["ef_rescale"] == {"from": 4, "to": 2, "path": "shrink"}
    jcfg, jsim, jstep, jinit = jbuild(2)
    p0, e0 = jinit(KEY)
    template = jckpt.TrainState(*jckpt.canonicalize_sim(jsim, p0, e0), key=KEY,
                                data_step=jnp.zeros((), jnp.int32))
    state, jmeta = jckpt.restore_train_state(str(tmp_path), template)
    assert jmeta["ef_rescale"] == meta["ef_rescale"]
    for got, want in zip(tree.leaves(bridge.to_numpy(e2.error)),
                         jax.tree_util.tree_leaves(state.ef.error)):
        np.testing.assert_array_equal(got, np.asarray(want))
    # and the rescaled run trains on
    p2, e2, tail = run(cfg, sim, step, p2, e2, None, 2, 4)
    assert all(np.isfinite(tail))


# ---------------------------------------------------------------------------
# one-step staleness
# ---------------------------------------------------------------------------

def _nonzero(t):
    return any(bool(x.any()) for x in tree.leaves(t))


def test_resume_bit_exact_one_step_mid_pipeline(tmp_path):
    """A save in mid pipeline, a nonzero aggregate parked in
    ``EFState.inflight``, resumes bit for bit: the envelope carries the
    in-flight tree like any other state, and no splice runs."""
    w = 4
    cfg, sim, step, init, _ = build(w, staleness="one_step")
    params, ef = init(torch.Generator().manual_seed(0))
    params, ef, head = run(cfg, sim, step, params, ef, None, 0, CKPT_AT)
    assert _nonzero(ef.inflight)
    save_at(tmp_path, sim, params, ef)
    params, ef, tail = run(cfg, sim, step, params, ef, None, CKPT_AT, STEPS)

    cfg, sim, step, _, p2, e2, meta = restore_into(tmp_path, w,
                                                   staleness="one_step")
    assert "inflight" not in meta and e2.step == CKPT_AT
    p2, e2, tail2 = run(cfg, sim, step, p2, e2, None, CKPT_AT, STEPS)
    assert tail2 == tail
    assert_bit_equal(p2, params)
    assert_bit_equal(e2.inflight, ef.inflight)
    assert_bit_equal(e2.error, ef.error)


def _strip_inflight(path):
    """Take the ``['ef'].inflight`` records out of the envelope at ``path``
    and mark it v1 (the crc recomputed)."""
    payload = msgpack.unpackb(open(path, "rb").read(), raw=False)
    kept = [d for d in payload["leaves"]
            if not d["path"].startswith("['ef'].inflight")]
    assert len(kept) < len(payload["leaves"])
    payload["leaves"] = kept
    crc = 0
    for d in kept:
        if d["kind"] == "array":
            crc = zlib.crc32(d["data"], crc)
    payload["crc32"] = crc
    payload["meta"]["train_state_version"] = 1
    with open(path, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))


def test_legacy_envelope_zero_fills_inflight(tmp_path):
    """A v1 envelope (no ``['ef'].inflight`` record) into a one-step
    template: the template's in-flight tensors are zeroed in place
    (``"zero_filled"``: one more pipeline bubble) and the run trains on."""
    w = 2
    cfg, sim, step, init, _ = build(w)
    params, ef = init(torch.Generator().manual_seed(0))
    params, ef, _ = run(cfg, sim, step, params, ef, None, 0, CKPT_AT)
    _strip_inflight(save_at(tmp_path, sim, params, ef))
    cfg, sim, step, _, p2, e2, meta = restore_into(tmp_path, w,
                                                   staleness="one_step")
    assert meta["inflight"] == "zero_filled" and e2.step == CKPT_AT
    assert not _nonzero(e2.inflight)
    assert_bit_equal(p2, params)
    before = tree.map(torch.clone, p2)
    p2, e2, tail = run(cfg, sim, step, p2, e2, None, CKPT_AT, CKPT_AT + 2)
    assert all(np.isfinite(tail)) and _nonzero(e2.inflight)
    # the replayed bubble applied zeros at step CKPT_AT, then step CKPT_AT's
    # aggregate at CKPT_AT + 1
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(p2), tree.leaves(before)))


def test_one_step_envelope_into_sync_template_drops(tmp_path):
    w = 2
    cfg, sim, step, init, _ = build(w, staleness="one_step")
    params, ef = init(torch.Generator().manual_seed(0))
    params, ef, _ = run(cfg, sim, step, params, ef, None, 0, CKPT_AT)
    save_at(tmp_path, sim, params, ef)
    cfg, sim, step, _, p2, e2, meta = restore_into(tmp_path, w)
    assert meta["inflight"] == "dropped" and e2.inflight is None
    assert_bit_equal(p2, params)
    p2, e2, tail = run(cfg, sim, step, p2, e2, None, CKPT_AT, CKPT_AT + 2)
    assert all(np.isfinite(tail))


@pytest.fixture(scope="module")
def stale_reference(tmp_path_factory):
    """The reference's one-step run at W = 2: start, 8 steps, its envelope
    at step 4 and the in-flight aggregate it holds."""
    directory = tmp_path_factory.mktemp("ref_stale")
    cfg, sim, step, init = jbuild(2, staleness="one_step")
    params, ef = init(KEY)
    start = (jfirst(params), jfirst(ef.comp))
    params, ef, head = jrun(cfg, sim, step, params, ef, 0, CKPT_AT)
    saved_inflight = jfirst(ef.inflight)
    jsave(directory, sim, params, ef)
    params, ef, tail = jrun(cfg, sim, step, params, ef, CKPT_AT, STEPS)
    return {"dir": directory, "start": start, "losses": head + tail,
            "params": jfirst(params), "inflight": saved_inflight,
            "jax": (cfg, sim, step, init)}


def test_reference_one_step_envelope_resumes_in_the_port(stale_reference):
    ref = stale_reference
    cfg, sim, step, _, params, ef, meta = restore_into(ref["dir"], 2,
                                                       staleness="one_step")
    assert "inflight" not in meta and ef.step == CKPT_AT
    for got, want in zip(tree.leaves(bridge.to_numpy(ef.inflight)),
                         tree.leaves(ref["inflight"])):
        np.testing.assert_array_equal(got, want)
    assert any(np.abs(x).max() > 0 for x in tree.leaves(ref["inflight"]))
    params, ef, tail = run(cfg, sim, step, params, ef, None, CKPT_AT, STEPS)
    hold(tail, bridge.to_numpy(params), ref["losses"][CKPT_AT:], ref["params"])


def test_port_one_step_envelope_resumes_in_the_reference(stale_reference,
                                                         tmp_path):
    ref = stale_reference
    params0, q0 = ref["start"]
    cfg, sim, step, _, _ = build(2, staleness="one_step")
    params = bridge.to_torch(params0)
    ef = error_feedback.EFState(
        error=tree.map(lambda p: torch.zeros((2,) + tuple(p.shape)), params),
        momentum=tree.map(torch.zeros_like, params), comp=bridge.to_torch(q0),
        inflight=tree.map(torch.zeros_like, params))
    params, ef, head = run(cfg, sim, step, params, ef, None, 0, CKPT_AT)
    np.testing.assert_allclose(head, ref["losses"][:CKPT_AT], rtol=1e-5)
    save_at(tmp_path, sim, params, ef)

    jcfg, jsim, jstep, jinit = ref["jax"]
    p0, e0 = jinit(jax.random.key(5))
    template = jckpt.TrainState(*jckpt.canonicalize_sim(jsim, p0, e0), key=KEY,
                                data_step=jnp.zeros((), jnp.int32))
    state, meta = jckpt.restore_train_state(str(tmp_path), template)
    assert "inflight" not in meta and int(state.ef.step) == CKPT_AT
    for got, want in zip(jax.tree_util.tree_leaves(state.ef.inflight),
                         tree.leaves(bridge.to_numpy(ef.inflight))):
        np.testing.assert_array_equal(np.asarray(got), want)
    jp, je = jckpt.replicate_sim(jsim, state.params, state.ef)
    jp, je, tail = jrun(jcfg, jsim, jstep, jp, je, CKPT_AT, STEPS)
    hold(tail, jfirst(jp), ref["losses"][CKPT_AT:], ref["params"])
