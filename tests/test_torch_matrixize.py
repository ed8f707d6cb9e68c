"""The port's planners against the JAX package's: bucket and flat-wire plans
must be EQUAL, entry for entry (they are pure Python over shapes), and
packing must round-trip exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jllama
from repro.core import matrixize as jmz
from repro.models import model as jmodel
from repro_torch import tree
from repro_torch.configs import llama3_8b
from repro_torch.core import matrixize as mz
from repro_torch.models import model


def _norm(x):
    """Plan tuples with dtypes as plain names, comparable across packages."""
    if isinstance(x, (tuple, list)):
        return tuple(_norm(v) for v in x)
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    if isinstance(x, np.dtype):
        return x.name
    return x


def _plans(jcfg, cfg):
    """Both packages' (leaf paths, matrix shapes, bucket plan) for a config,
    from shapes only (jax.eval_shape / torch meta tensors)."""
    jshapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jcfg))
    jleaves = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    jspecs = jax.tree_util.tree_leaves(jmodel.mspecs(jcfg))
    jms = []
    for (_, s), spec in zip(jleaves, jspecs):
        ms = jmz.matrix_shape(s.shape, spec)
        jms.append(None if ms is None else (int(np.prod(ms[0])), ms[1], ms[2]))
    params = model.init(cfg, None, device="meta")
    ms_list = []
    for (_, p), spec in zip(tree.items(params), tree.leaves(model.mspecs(cfg))):
        ms = mz.matrix_shape(tuple(p.shape), spec)
        ms_list.append(None if ms is None else (int(np.prod(ms[0])), ms[1], ms[2]))
    jpaths = [tuple(k.key for k in path) for path, _ in jleaves]
    paths = [path for path, _ in tree.items(params)]
    return ((jpaths, jms, jmz.plan_buckets(jms)),
            (paths, ms_list, mz.plan_buckets(ms_list)))


CONFIGS = {
    "llama3_8b_2layers": lambda m: dataclasses.replace(m.config(), num_layers=2),
    "llama3_8b_full": lambda m: m.config(),
    "llama3_8b_reduced": lambda m: m.reduced_config(),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bucket_plan_equals_reference(name):
    (jpaths, jms, jplan), (paths, ms_list, plan) = _plans(
        CONFIGS[name](jllama), CONFIGS[name](llama3_8b))
    assert paths == jpaths
    assert ms_list == jms
    assert dataclasses.astuple(plan) == dataclasses.astuple(jplan)


def test_full_width_two_layer_buckets():
    """The six slabs the kernels see at Llama-3-8B width, 2 layers."""
    cfg = dataclasses.replace(llama3_8b.config(), num_layers=2)
    _, (_, _, plan) = _plans(dataclasses.replace(jllama.config(), num_layers=2),
                             cfg)
    assert [(b.count, b.n, b.m) for b in plan.buckets] == [
        (1, 128256, 4096), (1, 4096, 128256), (2, 14336, 4096),
        (4, 4096, 14336), (4, 4096, 4096), (4, 4096, 1024)]
    n_params = sum(p.numel() for p in tree.leaves(model.init(cfg, None, "meta")))
    assert n_params == 1_486_901_248


def _flat_parts(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(3, 40, 2), (1, 17, 2), (9,), (4, 5), (2, 33, 2)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("wire_dtype,cap", [("auto", None), ("float32", None),
                                            ("auto", 400), ("float32", 256)])
def test_flat_plan_equals_reference(wire_dtype, cap):
    parts = _flat_parts()
    jplan = jmz.plan_flat([jnp.asarray(p) for p in parts], wire_dtype=wire_dtype,
                          max_chunk_bytes=cap)
    plan = mz.plan_flat([torch.tensor(p) for p in parts], wire_dtype=wire_dtype,
                        max_chunk_bytes=cap)
    jt = tuple((_norm(c.wire_dtype), _norm(dataclasses.astuple(c)[1]))
               for c in jplan.chunks)
    assert tuple((_norm(c.wire_dtype), _norm(dataclasses.astuple(c)[1]))
                 for c in plan.chunks) == jt
    assert plan.total_wire_bytes == jplan.total_wire_bytes


def test_flat_plan_ignores_worker_dims():
    parts = [torch.zeros((4,) + tuple(p.shape)) for p in map(torch.tensor, _flat_parts())]
    assert mz.plan_flat(parts, lead=1) == mz.plan_flat([p[0] for p in parts])


@pytest.mark.parametrize("wire_dtype", ["bfloat16", "int8", "int4"])
def test_unported_wire_dtypes_raise(wire_dtype):
    with pytest.raises(NotImplementedError, match="item 18"):
        mz.plan_flat([torch.zeros(3)], wire_dtype=wire_dtype)


def test_flat_pack_unpack_roundtrip():
    parts = [torch.tensor(p) for p in _flat_parts(1)]
    lead_parts = [torch.stack([p, 2 * p]) for p in parts]
    plan = mz.plan_flat(lead_parts, max_chunk_bytes=400, lead=1)
    out = {}
    for chunk in plan.chunks:
        buf = mz.pack_flat(chunk, lead_parts, lead=1)
        assert tuple(buf.shape) == (2, chunk.size)
        out.update(mz.unpack_flat(chunk, buf, leading=(2,)))
    for i, p in enumerate(lead_parts):
        assert torch.equal(out[i], p)


def test_bucket_pack_unpack_roundtrip():
    rng = np.random.default_rng(3)
    shapes = [(2, 30, 20), (1, 28, 19), None, (3, 30, 20)]
    plan = mz.plan_buckets(shapes)
    assert len(plan.buckets) == 1 and plan.buckets[0].count == 6
    mats = [None if s is None else
            torch.tensor(rng.standard_normal((2,) + s).astype(np.float32))
            for s in shapes]
    facs = [None if s is None else
            torch.tensor(rng.standard_normal((s[0], s[2], 3)).astype(np.float32))
            for s in shapes]
    bucket = plan.buckets[0]
    slab = mz.pack_matrices(bucket, mats, lead=1)
    qslab = mz.pack_factors(bucket, facs)
    assert tuple(slab.shape) == (2, 6, 30, 20)
    assert tuple(qslab.shape) == (6, 20, 3)
    for e in bucket.entries:
        assert torch.equal(mz.unpack_entry(slab, e, e.n, e.m, lead=1), mats[e.index])
        assert torch.equal(mz.unpack_entry(qslab, e, e.m), facs[e.index])
    # zero padding really is zero
    e = next(e for e in bucket.entries if e.n < bucket.n)
    blk = slab[:, e.offset:e.offset + e.count]
    assert not blk[:, :, e.n:].any() and not blk[:, :, :, e.m:].any()


def test_single_unpadded_leaf_packs_without_copy():
    x = torch.zeros(2, 3, 8, 6)
    plan = mz.plan_buckets([(3, 8, 6)])
    assert mz.pack_matrices(plan.buckets[0], [x], lead=1) is x


@pytest.mark.parametrize("shape,kind,bd", [((4, 32, 16), "matrix", 1),
                                           ((8, 3, 3, 3), "conv", 0),
                                           ((6, 5, 2, 7), "matrix", 0)])
def test_to_matrix_matches_reference(shape, kind, bd):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want = jmz.to_matrix(jnp.asarray(x), jmz.MatrixSpec(kind, bd))
    spec = mz.MatrixSpec(kind, bd)
    got = mz.to_matrix(torch.tensor(x), spec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(mz.from_matrix(got, shape, spec), torch.tensor(x))


def test_compressed_floats_match_reference():
    for shape, spec, r in [((4, 32, 16), jmz.MatrixSpec("matrix", 1), 2),
                           ((8, 3, 3, 3), jmz.MatrixSpec("conv", 0), 4),
                           ((7,), jmz.NONE, 2)]:
        pspec = mz.MatrixSpec(spec.kind, spec.batch_dims)
        assert (mz.compressed_floats(shape, pspec, r)
                == jmz.compressed_floats(shape, spec, r))
        assert mz.matrix_shape(shape, pspec) == jmz.matrix_shape(shape, spec)
