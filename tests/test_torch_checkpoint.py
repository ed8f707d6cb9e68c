"""The port's checkpoint envelope (``repro_torch.checkpoint``) against the
JAX package's (``repro.checkpoint``) and the ``msgpack`` package.

* The codec (``repro_torch.checkpoint.codec``): ``packb`` equals
  ``msgpack.packb(obj, use_bin_type=True)`` byte for byte and ``unpackb``
  equals ``msgpack.unpackb(data, raw=False)``, on envelope payloads and at
  the fix/8/16/32 boundaries of every type the envelope uses.
* The cases of ``tests/test_checkpoint.py`` against the port: round trip
  with meta, bfloat16 bit-exact, mismatches named by leaf, truncation and
  bit flips rejected, v1, fsync before replace, the orphan sweep, a failed
  save leaving no tmp, retention, the model-degree guard, and the
  ``TrainState`` envelope's seed, rank, worker-count and controller cases.
* Across packages: the same tree saved by each package decodes to the same
  payload but ``treedef`` (declared divergence: the port writes its own
  structure string), and restores in the other bit for bit.
* A leaf over one bin32 (2³² − 1 bytes) raises naming its path before
  anything is written (shown with a meta tensor, nothing allocated).
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core.error_feedback import EFState as JEFState
from repro.core.powersgd import RankController as JRankController
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import codec, msgpack_ckpt
from repro_torch.core import powersgd
from repro_torch.core.error_feedback import EFState


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
        2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
        -2**31 - 1, -2**63]
SIZES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]
PAYLOADS = {
    "ints": INTS,
    "floats": [0.0, -0.0, 1.5, 1e300, -2.5e-308, float("inf")],
    "scalars": [None, True, False, "", "é" * 20],
    "str": ["a" * n for n in SIZES],
    "bin": [b"x" * n for n in SIZES],
    "array": [list(range(n)) for n in SIZES],
    "map": [{str(i): i for i in range(n)} for n in (0, 15, 16, 65535, 65536)],
    "nested": {"leaves": [{"kind": "array", "dtype": "<f4", "shape": [2, 3],
                           "data": bytes(24), "path": "['a']"},
                          {"kind": "none", "path": "['b']"}],
               "meta": {"workers": 4, "controller": {
                   "rank": 2, "ema": 0.25, "history": [[0, 1], [3, 2]],
                   "key_data": [0, 17], "key_dtype": "key<fry>"},
                   "mesh_shape": {"data": 2, "model": 1}, "last": None},
               "tuple": (1, (2, 3))},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_codec_matches_msgpack_byte_for_byte(name):
    obj = PAYLOADS[name]
    want = msgpack.packb(obj, use_bin_type=True)
    got = codec.packb(obj)
    assert got == want
    assert codec.unpackb(want) == msgpack.unpackb(want, raw=False)
    # a float32 on the wire (msgpack's use_single_float) reads back too
    assert codec.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5


def test_codec_reads_a_reference_envelope_and_writes_it_back(tmp_path):
    """A whole envelope the JAX package wrote: decoded as ``msgpack`` does,
    packed back to the same bytes, and its large bins left in the file by
    ``unpack_file``."""
    path = jckpt.save_checkpoint(str(tmp_path), 3, _jax_tree(),
                                 meta={"workers": 2, "x": [1.5, None]})
    raw = open(path, "rb").read()
    payload = codec.unpackb(raw)
    assert payload == msgpack.unpackb(raw, raw=False)
    assert codec.packb(payload) == raw
    lazy = codec.unpack_file(path, lazy_from=16)
    for d, e in zip(lazy["leaves"], payload["leaves"]):
        if d["kind"] == "array":
            data = d["data"]
            got = data.tobytes() if isinstance(data, codec.Blob) else data
            assert got == e["data"]
    assert any(isinstance(d.get("data"), codec.Blob) for d in lazy["leaves"])


@pytest.mark.parametrize("cut", [1, 7, 100])
def test_codec_rejects_truncation_and_extra_bytes(cut):
    raw = msgpack.packb(PAYLOADS["nested"], use_bin_type=True)
    with pytest.raises(ValueError):
        codec.unpackb(raw[:-cut])
    with pytest.raises(ValueError):
        codec.unpackb(raw + b"\x00" * cut)


# ---------------------------------------------------------------------------
# the envelope (the cases of tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16), "d": None},
            "empty": torch.zeros(0, 3),
            "step": torch.tensor(7, dtype=torch.int32)}


def _jax_tree():
    return {"a": jnp.arange(6.0).reshape(2, 3),
            "b": {"c": jnp.ones(4, jnp.bfloat16), "d": None},
            "step": jnp.int32(7)}


def _zeros_like(t):
    return {"a": torch.zeros(2, 3),
            "b": {"c": torch.zeros(4, dtype=torch.bfloat16), "d": None},
            "empty": torch.zeros(0, 3),
            "step": torch.tensor(0, dtype=torch.int32)}


def _leaves(t):
    return [x for _, x in msgpack_ckpt.flatten_with_paths(t)]


def test_v2_roundtrip_with_meta(tmp_path):
    tree = _tree()
    ckpt.save_checkpoint(str(tmp_path), 7, tree, meta={"workers": 4, "note": "x"})
    template = _zeros_like(tree)
    restored, step = ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 7
    for a, b in zip(_leaves(restored), _leaves(tree)):
        assert (a is None and b is None) or (a.dtype == b.dtype
                                             and torch.equal(a, b))
    assert restored["b"]["d"] is None
    # read in place into the template's tensors
    assert restored["a"] is template["a"]
    assert ckpt.checkpoint_meta(str(tmp_path)) == {"workers": 4, "note": "x"}


def test_bfloat16_roundtrips_exactly(tmp_path):
    w = torch.arange(7, dtype=torch.bfloat16) * 0.3
    ckpt.save_checkpoint(str(tmp_path), 0, {"w": w})
    restored, _ = ckpt.restore_checkpoint(
        str(tmp_path), {"w": torch.zeros(7, dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16), w.view(torch.int16))
    payload = msgpack.unpackb(open(os.path.join(
        str(tmp_path), "ckpt_0000000000.msgpack"), "rb").read(), raw=False)
    assert payload["leaves"][0]["dtype"] == "bfloat16"


MISMATCHES = {
    "dtype": ({"m": {"w": torch.zeros(3)}},
              {"m": {"w": torch.zeros(3, dtype=torch.bfloat16)}},
              r"\['m'\]\['w'\].*dtype.*float32.*bfloat16"),
    "shape": ({"m": {"w": torch.zeros(3, 2)}}, {"m": {"w": torch.zeros(3, 4)}},
              r"\['m'\]\['w'\].*shape"),
    "structure": ({"p": torch.zeros(3), "q": torch.ones(3)},
                  {"p": torch.zeros(3), "r": torch.ones(3)},
                  "structure mismatch"),
    "count": ({"p": torch.zeros(3)}, {"p": torch.zeros(3), "q": torch.zeros(3)},
              "1 leaves in checkpoint, 2 in template"),
    "none": ({"p": None}, {"p": torch.zeros(3)}, r"\['p'\]: checkpoint has None"),
}


@pytest.mark.parametrize("case", sorted(MISMATCHES))
def test_mismatch_names_the_leaf_and_writes_nothing(tmp_path, case):
    saved, template, pattern = MISMATCHES[case]
    ckpt.save_checkpoint(str(tmp_path), 1, saved)
    before = [None if x is None else x.clone() for x in _leaves(template)]
    with pytest.raises(ckpt.CheckpointError, match=pattern):
        ckpt.restore_checkpoint(str(tmp_path), template)
    for x, y in zip(_leaves(template), before):
        assert (x is None and y is None) or torch.equal(x, y)


def _corrupt(path, how):
    raw = bytearray(open(path, "rb").read())
    if how == "truncated":
        raw = raw[:len(raw) // 2]
    else:   # a flipped bit in the middle of the float payload
        raw[len(raw) // 2] ^= 0x10
    with open(path, "wb") as f:
        f.write(bytes(raw))


@pytest.mark.parametrize("how,pattern", [("truncated", "truncated or corrupted"),
                                         ("bitflip", "checksum")])
def test_corrupted_checkpoint_rejected(tmp_path, how, pattern):
    tree = {"w": torch.ones(1024)}
    path = ckpt.save_checkpoint(str(tmp_path), 3, tree)
    _corrupt(path, how)
    with pytest.raises(ckpt.CheckpointError, match=pattern) as e:
        ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(1024)})
    assert os.path.basename(path) in str(e.value)


def test_legacy_v1_envelope_still_restores(tmp_path):
    arr = np.arange(4.0, dtype=np.float32)
    payload = {"step": 5, "treedef": "ignored",
               "leaves": [{"kind": "array", "dtype": arr.dtype.str,
                           "shape": list(arr.shape), "data": arr.tobytes()}]}
    with open(os.path.join(str(tmp_path), "ckpt_0000000005.msgpack"), "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    restored, step = ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(4)})
    assert step == 5
    np.testing.assert_array_equal(restored["w"].numpy(), arr)
    assert ckpt.checkpoint_meta(str(tmp_path)) == {}


def test_save_fsyncs_before_replace(tmp_path, monkeypatch):
    synced = []
    real_fsync, real_replace = os.fsync, os.replace

    def spy_fsync(fd):
        synced.append("fsync")
        return real_fsync(fd)

    def spy_replace(src, dst):
        assert "fsync" in synced, "os.replace before any fsync"
        synced.append("replace")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "fsync", spy_fsync)
    monkeypatch.setattr(os, "replace", spy_replace)
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3)})
    assert "replace" in synced
    # and the directory entry is fsynced after the rename
    assert synced.index("replace") < len(synced) - 1


def test_orphaned_tmp_files_swept(tmp_path):
    (tmp_path / "abcdef.tmp").write_bytes(b"half-written checkpoint")
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3)})
    assert sorted(os.listdir(tmp_path)) == ["ckpt_0000000001.msgpack"]


def test_failed_save_leaves_no_tmp(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(msgpack_ckpt.codec, "pack", boom)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3)})
    assert [n for n in os.listdir(tmp_path) if n.endswith(".tmp")] == []


def test_retention_latest_and_vanishing_files(tmp_path, monkeypatch):
    tree = {"w": torch.zeros(3)}
    for s in range(6):
        ckpt.save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    real_remove = os.remove

    def racy_remove(path):
        real_remove(path)              # the file vanishes...
        raise FileNotFoundError(path)  # ...and the racer sees ENOENT

    monkeypatch.setattr(msgpack_ckpt.os, "remove", racy_remove)
    ckpt.save_checkpoint(str(tmp_path), 6, tree, keep=1)  # must not raise
    monkeypatch.undo()
    assert ckpt.all_steps(str(tmp_path)) == [6]


def test_save_and_restore_keep_no_reference_to_the_state(tmp_path):
    """With the garbage collector off, a saved tree and a restored one are
    freed as soon as the caller drops them: at full width an old state kept
    alive costs the card a second copy of the error buffers (11 GiB)."""
    import gc
    import weakref

    enabled = gc.isenabled()
    gc.disable()
    try:
        tree = {"a": torch.ones(8), "b": {"c": torch.zeros(2, 2)}}
        refs = [weakref.ref(x) for x in _leaves(tree)]
        ckpt.save_checkpoint(str(tmp_path), 1, tree)
        del tree
        assert all(r() is None for r in refs)
        got, _ = ckpt.restore_checkpoint(
            str(tmp_path), {"a": torch.zeros(8), "b": {"c": torch.ones(2, 2)}})
        refs = [weakref.ref(x) for x in _leaves(got)]
        del got
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


def test_leaf_over_one_bin_raises_with_its_path(tmp_path):
    """``embed``'s error buffer at full width and W = 2 is 97.9 % of a
    bin32; one element more than the cap must raise before anything is
    written (a meta tensor: no storage)."""
    big = torch.empty((2**30,), dtype=torch.float32, device="meta")
    assert big.numel() * 4 == codec.BIN_MAX + 1
    directory = tmp_path / "ck"
    with pytest.raises(ckpt.CheckpointError,
                       match=r"leaf \['ef'\]\['error'\]: 4,294,967,296 bytes"):
        ckpt.save_checkpoint(str(directory), 1,
                             {"ef": {"error": big}, "w": torch.zeros(3)})
    assert not directory.exists()
    # the largest full-width leaf fits
    msgpack_ckpt.check_leaf_sizes(
        [("embed", torch.empty((2, 128256, 4096), device="meta"))])


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _to_jax(t):
    def leaf(x):
        if x is None:
            return None
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(x.numpy())
    return jax.tree_util.tree_map(leaf, t, is_leaf=lambda x: x is None
                                  or isinstance(x, torch.Tensor))


def _payload(path):
    return msgpack.unpackb(open(path, "rb").read(), raw=False)


def test_same_tree_same_payload_but_treedef_and_restores_across(tmp_path):
    tree = {"a": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)),
            "b": {"c": (torch.arange(9, dtype=torch.bfloat16) * 0.7).reshape(3, 3),
                  "d": None, "i": torch.arange(4, dtype=torch.int32),
                  "u": torch.tensor([0, 7], dtype=torch.uint32)},
            "flag": torch.tensor([True, False]),
            "step": torch.tensor(9, dtype=torch.int32)}
    meta = {"workers": 2, "controller": None, "history": [[0, 1], [4, 2]]}
    p_port = ckpt.save_checkpoint(str(tmp_path / "port"), 9, tree, meta=meta)
    jtree = _to_jax(tree)
    p_ref = jckpt.save_checkpoint(str(tmp_path / "ref"), 9, jtree, meta=meta)
    a, b = _payload(p_port), _payload(p_ref)
    assert a.pop("treedef") != b.pop("treedef")
    assert a == b
    # the reference restores the port's envelope, the port the reference's
    got, step = jckpt.restore_checkpoint(str(tmp_path / "port"), jtree)
    assert step == 9
    for x, y in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jtree)):
        assert x.dtype == y.dtype
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    template = {"a": torch.zeros(3, 5),
                "b": {"c": torch.zeros(3, 3, dtype=torch.bfloat16), "d": None,
                      "i": torch.zeros(4, dtype=torch.int32),
                      "u": torch.zeros(2, dtype=torch.uint32)},
                "flag": torch.zeros(2, dtype=torch.bool),
                "step": torch.tensor(0, dtype=torch.int32)}
    got, _ = ckpt.restore_checkpoint(str(tmp_path / "ref"), template)
    for x, y in zip(_leaves(got), _leaves(tree)):
        assert (x is None and y is None) or (
            x.dtype == y.dtype and bytes(x.reshape(-1).view(torch.uint8).numpy())
            == bytes(y.reshape(-1).view(torch.uint8).numpy()))


# ---------------------------------------------------------------------------
# the TrainState envelope
# ---------------------------------------------------------------------------

def _train_state(workers=1, rank=2, seed=11):
    g = torch.Generator().manual_seed(seed)
    ef = EFState(error={"w": torch.arange(float(workers * 6)).reshape(workers, 6)},
                 momentum={"w": torch.ones(6)},
                 comp={"w": torch.randn(6, rank, generator=g), "b": None}, step=4)
    return ckpt.TrainState(params={"w": torch.full((6,), 2.0)}, ef=ef, seed=seed,
                           data_step=4)


def _jax_train_state(workers=1, rank=2):
    key = jax.random.key(11)
    ef = JEFState(
        error={"w": jnp.arange(float(workers * 6)).reshape(workers, 6)},
        momentum={"w": jnp.ones(6)},
        comp={"w": jax.random.normal(key, (6, rank)), "b": None},
        step=jnp.int32(4))
    return jckpt.TrainState(params={"w": jnp.full((6,), 2.0)}, ef=ef, key=key,
                            data_step=jnp.int32(4))


def test_train_state_roundtrip_keeps_seed_and_cursor(tmp_path):
    st = _train_state()
    ckpt.save_train_state(str(tmp_path), st, extra_meta={"last_residual": 0.5})
    restored, meta = ckpt.restore_train_state(str(tmp_path), _train_state(seed=3))
    assert meta["workers"] == 1 and meta["last_residual"] == 0.5
    assert meta["key_dtype"] == "key<fry>" and meta["model_axis_size"] == 1
    assert restored.seed == 11 and restored.ef.step == 4
    assert restored.data_step == 4
    assert torch.equal(restored.ef.comp["w"], st.ef.comp["w"])
    # the envelope's key is jax.random.key(11)'s data, restored as such
    jstate, _ = jckpt.restore_train_state(str(tmp_path), _jax_train_state())
    np.testing.assert_array_equal(jax.random.key_data(jstate.key),
                                  jax.random.key_data(jax.random.key(11)))


def test_train_state_paths_are_the_reference_s(tmp_path):
    ckpt.save_train_state(str(tmp_path / "port"), _train_state())
    jckpt.save_train_state(str(tmp_path / "ref"), _jax_train_state())
    a = _payload(os.path.join(str(tmp_path / "port"), "ckpt_0000000004.msgpack"))
    b = _payload(os.path.join(str(tmp_path / "ref"), "ckpt_0000000004.msgpack"))
    strip = lambda p: [(d["path"], d["kind"], d.get("dtype"), d.get("shape"))
                       for d in p["leaves"]]
    assert strip(a) == strip(b)
    assert a["meta"] == b["meta"]


def test_seed_outside_32_bits_raises():
    with pytest.raises(ValueError, match="2\\*\\*32"):
        ckpt.save_train_state("/nonexistent", _train_state(seed=2**32))


def test_train_state_rejects_plain_checkpoint(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"params": {"w": torch.zeros(3)}})
    with pytest.raises(ckpt.CheckpointError, match="train_state_version"):
        ckpt.restore_train_state(str(tmp_path), _train_state())


def test_restore_keeps_checkpoint_rank(tmp_path):
    ckpt.save_train_state(str(tmp_path), _train_state(rank=2))
    restored, _ = ckpt.restore_train_state(str(tmp_path), _train_state(rank=4))
    assert tuple(restored.ef.comp["w"].shape) == (6, 2)


@pytest.mark.parametrize("w_new,path", [(4, "identity"), (8, "grow"),
                                        (2, "shrink"), (3, "coprime-mean")])
def test_restore_rescales_error_buffers_as_the_reference(tmp_path, w_new, path):
    """``meta["ef_rescale"]`` names the path that ran, the buffers equal
    the reference's rescale of the same envelope, and the saved meta stays
    clean."""
    ckpt.save_train_state(str(tmp_path), _train_state(workers=4))
    with pytest.warns(UserWarning, match="coprime") if path == "coprime-mean" \
            else contextlib.nullcontext():
        restored, meta = ckpt.restore_train_state(str(tmp_path),
                                                  _train_state(workers=w_new))
    assert meta["ef_rescale"] == {"from": 4, "to": w_new, "path": path}
    with pytest.warns(UserWarning) if path == "coprime-mean" \
            else contextlib.nullcontext():
        jstate, jmeta = jckpt.restore_train_state(
            str(tmp_path), _jax_train_state(workers=w_new))
    assert jmeta["ef_rescale"] == meta["ef_rescale"]
    np.testing.assert_array_equal(restored.ef.error["w"].numpy(),
                                  np.asarray(jstate.ef.error["w"]))
    assert "ef_rescale" not in ckpt.checkpoint_meta(str(tmp_path))


def test_model_axis_guard_names_both_sizes(tmp_path):
    """The reference saves at model degree 2: the port's restore at 1 names
    both sizes.  The port saves at model degree 2 too, recording the degree
    and the grid as the reference does; its own envelope restores at 2 and
    is refused at 1 and 4, naming both sizes."""
    jckpt.save_train_state(str(tmp_path / "jax"), _jax_train_state(),
                           model_axis_size=2, mesh_shape={"data": 2, "model": 2})
    with pytest.raises(ckpt.CheckpointError,
                       match="model_axis_size=2.*model_axis_size=1"):
        ckpt.restore_train_state(str(tmp_path / "jax"), _train_state(),
                                 model_axis_size=1)
    ckpt.check_model_axis({}, 1)
    with pytest.raises(ckpt.CheckpointError, match="model_axis_size=1.*=2"):
        ckpt.check_model_axis({}, 2)
    ckpt.save_train_state(str(tmp_path / "port"), _train_state(),
                          model_axis_size=2, mesh_shape={"data": 2, "model": 2})
    meta = ckpt.checkpoint_meta(str(tmp_path / "port"))
    want = jckpt.checkpoint_meta(str(tmp_path / "jax"))
    for key in ("model_axis_size", "mesh_shape"):
        assert meta[key] == want[key]
    _, meta = ckpt.restore_train_state(str(tmp_path / "port"), _train_state(),
                                       model_axis_size=2)
    assert meta["model_axis_size"] == 2
    for size in (1, 4):
        with pytest.raises(ckpt.CheckpointError,
                           match=f"model_axis_size=2.*model_axis_size={size}"):
            ckpt.restore_train_state(str(tmp_path / "port"), _train_state(),
                                     model_axis_size=size)


def test_in_flight_aggregate_is_not_taken(tmp_path):
    """The JAX package's one-step envelope (arrays under
    ``['ef'].inflight``) restores into a one-step template bit for bit, no
    splice noted, and into a synchronous template with its aggregate
    dropped (``meta["inflight"] == "dropped"``); one without the record
    (v1) restores with ``meta["inflight"] == "absent"``."""
    st = _jax_train_state()
    inflight = jnp.arange(6.0) * 0.25 - 0.5
    st = jckpt.TrainState(params=st.params, ef=JEFState(
        error=st.ef.error, momentum=st.ef.momentum, comp=st.ef.comp,
        step=st.ef.step, inflight={"w": inflight}), key=st.key,
        data_step=st.data_step)
    jckpt.save_train_state(str(tmp_path / "stale"), st)
    template = _train_state()
    template.ef.inflight = {"w": torch.full((6,), 7.0)}
    slot = template.ef.inflight["w"]
    restored, meta = ckpt.restore_train_state(str(tmp_path / "stale"), template)
    assert "inflight" not in meta and restored.ef.inflight["w"] is slot
    np.testing.assert_array_equal(slot.numpy(), np.asarray(inflight))
    restored, meta = ckpt.restore_train_state(str(tmp_path / "stale"),
                                              _train_state())
    assert meta["inflight"] == "dropped" and restored.ef.inflight is None
    assert torch.equal(restored.params["w"], torch.full((6,), 2.0))
    path = ckpt.save_train_state(str(tmp_path / "v1"), _train_state())
    payload = _payload(path)
    payload["leaves"] = [d for d in payload["leaves"]
                         if d["path"] != "['ef'].inflight"]
    payload["meta"]["train_state_version"] = 1
    with open(path, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    restored, meta = ckpt.restore_train_state(str(tmp_path / "v1"), _train_state())
    assert meta["inflight"] == "absent" and restored.ef.step == 4


def test_zero_fill_builds_no_buffer(tmp_path):
    """A synchronous envelope restored into a one-step template: the
    spliced in-flight records carry their length only
    (``msgpack_ckpt.ZeroBytes``), and the template's own tensor is zeroed
    in place (``meta["inflight"] == "zero_filled"``), as the JAX package's
    restore zero-fills it."""
    from repro_torch.checkpoint import train_state

    ckpt.save_train_state(str(tmp_path), _train_state())
    template = _train_state()
    template.ef.inflight = {"w": torch.full((6,), 7.0)}
    slot = template.ef.inflight["w"]
    payload, note = train_state._splice_inflight(
        ckpt.load_envelope(str(tmp_path)), train_state._as_tree(template))
    zeros = [d for d in payload["leaves"]
             if d["path"].startswith("['ef'].inflight")]
    assert note == "zero_filled" and len(zeros) == 1
    assert isinstance(zeros[0]["data"], msgpack_ckpt.ZeroBytes)
    assert len(zeros[0]["data"]) == 6 * 4
    restored, meta = ckpt.restore_train_state(str(tmp_path), template)
    assert meta["inflight"] == "zero_filled"
    assert restored.ef.inflight["w"] is slot and not slot.any()
    assert torch.equal(restored.ef.momentum["w"], torch.ones(6))


def test_controller_state_dict_crosses_both_ways():
    """rank, ema and history cross exactly.  Declared divergence: the
    column stream does not.  The port reading the JAX package's dict keeps
    its own seed and counts ``len(history) - 1`` switches, so its next
    growth draws what a port run from the start would draw; the JAX
    package reading the port's gets ``jax.random.key(seed)``."""
    spec = "1@0,2@3,4@6"
    j = JRankController(spec)
    j.update(None, 0)
    j.update({"w": jnp.zeros((8, 1))}, 3)
    j.observe(0.4)
    p = powersgd.RankController(spec)
    p.update(None, 0)
    p.update({"w": torch.zeros(8, 1)}, 3)
    p.observe(0.4)
    jd, pd = j.state_dict(), p.state_dict()
    for k in ("rank", "ema", "history", "key_dtype"):
        assert jd[k] == pd[k], k
    assert pd["key_data"] == [0, 17] and (pd["seed"], pd["switches"]) == (17, 1)
    from_ref = powersgd.RankController(spec).load_state_dict(jd)
    assert (from_ref.rank, from_ref.history, from_ref._ema) == (2, [(0, 1), (3, 2)], 0.4)
    assert (from_ref.seed, from_ref.switches) == (17, 1)
    n1, _ = from_ref.update({"w": torch.zeros(8, 2)}, 6)
    n2, _ = p.update({"w": torch.zeros(8, 2)}, 6)
    assert torch.equal(n1["w"], n2["w"])
    from_port = JRankController(spec).load_state_dict(pd)
    assert (from_port.rank, from_port.history) == (2, [(0, 1), (3, 2)])
    np.testing.assert_array_equal(jax.random.key_data(from_port.key), [0, 17])
