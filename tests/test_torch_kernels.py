"""The port's low-rank products against the JAX package's Pallas kernels.

On the CPU, ``repro_torch.kernels.ops`` takes the plain PyTorch version; it
is held here against ``repro.kernels.ops`` run as ``tests/test_kernels.py``
runs it (Pallas in interpret mode).  Tolerance atol 1e-4, rtol 1e-4: fp32
with a different summation order.  The CUDA kernels themselves are held
against the plain version on the card by ``chip_smoke.py`` and by the
``cuda``-marked test below.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.bench import common as bench
from repro_torch.configs import llama3_8b
from repro_torch.kernels import _build, lowrank, ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = RTOL = 1e-4

# the bucket slabs (B, n, m) of the benchmark LM (LMSpec: d_model 128, 2
# layers, vocab 256) with its 4 workers folded into B, and of full-width
# 2-layer Llama-3-8B with 2 workers
LM_SLABS = [(8, 512, 128), (16, 128, 512), (4, 256, 128), (4, 128, 256),
            (32, 128, 128)]
LLAMA_SLABS = [(2, 128256, 4096), (2, 4096, 128256), (4, 14336, 4096),
               (8, 4096, 14336), (8, 4096, 4096), (8, 4096, 1024)]
RAGGED_2D = ((1000, 1023), 3)

# 2-D, 3-D and 4-D inputs, r from 1 to 8, ragged n and m; the benchmark
# LM's slabs at rank 2 and the ragged 2-D check
CASES = [((37, 53), 1), ((64, 128), 2), ((3, 45, 70), 3),
         ((2, 3, 33, 17), 4), ((5, 129, 31), 8), ((1, 300, 7), 5)]
CASES += [(slab, 2) for slab in LM_SLABS] + [RAGGED_2D]


def _inputs(shape, r, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal(shape[:-2] + (shape[-1], r)).astype(np.float32)
    p = rng.standard_normal(shape[:-2] + (shape[-2], r)).astype(np.float32)
    return m, q, p


@pytest.mark.parametrize("shape,r", CASES)
def test_project_matches_pallas(shape, r):
    m, q, _ = _inputs(shape, r, seed=r)
    want = jops.lowrank_project(jnp.asarray(m), jnp.asarray(q),
                                block_n=64, block_k=64)
    got = ops.lowrank_project(torch.tensor(m), torch.tensor(q))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,r", CASES)
def test_backproject_matches_pallas(shape, r):
    m, _, p = _inputs(shape, r, seed=100 + r)
    want = jops.lowrank_backproject(jnp.asarray(m), jnp.asarray(p),
                                    block_n=64, block_k=64)
    got = ops.lowrank_backproject(torch.tensor(m), torch.tensor(p))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_decompress_matches_reference():
    rng = np.random.default_rng(7)
    p = rng.standard_normal((3, 40, 4)).astype(np.float32)
    q = rng.standard_normal((3, 25, 4)).astype(np.float32)
    np.testing.assert_allclose(
        ref.decompress(torch.tensor(p), torch.tensor(q)).numpy(),
        np.asarray(jref.decompress(jnp.asarray(p), jnp.asarray(q))),
        atol=1e-5, rtol=1e-5)


def test_ops_on_cpu_never_launch():
    lowrank.reset_launches()
    m, q, p = (torch.tensor(a) for a in _inputs((4, 30, 20), 2, seed=0))
    ops.lowrank_project(m, q)
    ops.lowrank_backproject(m, p)
    assert lowrank.LAUNCHES == {"lowrank_project": 0, "lowrank_backproject": 0}


@pytest.mark.parametrize("fn", [lowrank.lowrank_project,
                                lowrank.lowrank_backproject])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    """The wrappers launch or raise; they never compute on the CPU."""
    m = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(m, torch.zeros(2, 8, 2))
    assert lowrank.LAUNCHES[fn.__name__] == 0


def test_build_failure_reports_nvcc_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build("lowrank")
    assert not list(tmp_path.iterdir())


def test_build_path_is_keyed_by_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a")
    first = _build.library_path(src)
    assert first == _build.library_path(src)
    src.write_text("// b")
    assert _build.library_path(src) != first
    assert first.parent == _build.BUILD_DIR


# ---------------------------------------------------------------------------
# the launch plan: a pure function of (B, n, m, r, SMs, alignment)
# ---------------------------------------------------------------------------

H100_SMS = 132
PLANNERS = {"project": lowrank.plan_project, "backproject": lowrank.plan_backproject}
PLAN_SHAPES = ([(slab, 2) for slab in LLAMA_SLABS + LM_SLABS]
               + [((1,) + RAGGED_2D[0], RAGGED_2D[1])])


def _slabs(cfg, workers):
    return [(workers * bk.count, bk.n, bk.m) for bk in bench.model_buckets(cfg)]


def test_listed_slabs_are_the_models_buckets():
    assert _slabs(bench._make_cfg(bench.LMSpec()), bench.LMSpec().workers) == LM_SLABS
    llama = dataclasses.replace(llama3_8b.config(), num_layers=2)
    assert _slabs(llama, 2) == LLAMA_SLABS


def _check_plan(kind, plan, b, n, m, r):
    """The plan's invariants, as ``lowrank.cu`` checks them before a launch."""
    reduced = m if kind == "project" else n
    assert 1 <= plan.cluster <= lowrank.CLUSTER_MAX == 8
    # the ranks' runs of the reduced dim, as lowrank.cu cuts them, cover it
    # exactly once, none empty
    runs = [(k * plan.extent, min(reduced, (k + 1) * plan.extent))
            for k in range(plan.cluster)]
    assert runs[0][0] == 0 and runs[-1][1] == reduced
    assert all(a < z for a, z in runs)
    assert all(z == a for (_, z), (a, _) in zip(runs, runs[1:]))
    assert plan.vec in (1, 4)
    if plan.vec == 4:
        assert m % 4 == 0
    if kind == "project":
        assert plan.col_warps in (1, 2, 4, 8)
        assert plan.tile * plan.col_warps % lowrank.NUM_WARPS == 0
        assert 1 <= plan.tile * plan.col_warps <= 32
        # every warp sharing a row has a 128-column step of each rank's run
        assert plan.col_warps * 128 <= max(128, plan.extent) + 127
        assert plan.tiles == b * math.ceil(n / plan.tile)
        assert 1 <= plan.window and plan.window * lowrank.rank_pad(r) <= lowrank.WINDOW_FLOATS
        if plan.vec == 4:
            assert plan.extent % 4 == 0 and plan.window % 4 == 0
    else:
        assert plan.lanes in (8, 16, 32)
        assert plan.tile == plan.lanes * lowrank.lane_cols(lowrank.rank_pad(r))
        assert plan.vec == 1 or lowrank.rank_pad(r) <= 8
        assert plan.tiles == b * math.ceil(m / plan.tile)
    assert plan.ctas == plan.tiles * plan.cluster < 2**31


@pytest.mark.parametrize("kind", sorted(PLANNERS))
@pytest.mark.parametrize("shape,r", PLAN_SHAPES)
def test_launch_plan_at_main_path_slabs(kind, shape, r):
    """At every Llama-3-8B and benchmark-LM slab and at (1000, 1023): a pure
    function of its arguments, splits within a cluster, the reduced dim
    covered exactly once, and a full wave of CTAs (one per SM) wherever the
    slab holds 16 KB of M per SM."""
    b, n, m = shape
    plan = PLANNERS[kind](b, n, m, r, H100_SMS)
    for other in PLAN_SHAPES:   # no state carried from call to call
        PLANNERS[kind](*other[0], other[1], H100_SMS)
    assert PLANNERS[kind](b, n, m, r, H100_SMS) == plan
    _check_plan(kind, plan, b, n, m, r)
    if 4 * b * n * m >= H100_SMS * 16 * 1024:
        assert plan.ctas >= H100_SMS
    unaligned = PLANNERS[kind](b, n, m, r, H100_SMS, aligned=False)
    assert unaligned.vec == 1
    _check_plan(kind, unaligned, b, n, m, r)


@settings(deadline=None, max_examples=300)
@given(kind=st.sampled_from(sorted(PLANNERS)), b=st.integers(1, 64),
       n=st.integers(1, 5000), m=st.integers(1, 5000), r=st.integers(1, 32),
       sms=st.sampled_from([1, 8, 114, 132]), aligned=st.booleans())
def test_launch_plan_invariants(kind, b, n, m, r, sms, aligned):
    plan = PLANNERS[kind](b, n, m, r, sms, aligned=aligned)
    _check_plan(kind, plan, b, n, m, r)
    assert aligned or plan.vec == 1


# ---------------------------------------------------------------------------
# on the card (skips here)
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _offset_view(a, offset):
    """``a`` on the card in a buffer ``offset`` floats past an aligned start."""
    buf = torch.empty(a.size + offset, device="cuda")
    view = buf[offset:].view(a.shape)
    view.copy_(torch.tensor(a))
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("shape,r", [((3, 100, 64), 2), ((1000, 1023), 3),
                                     ((8, 512, 1024), 32), ((8, 512, 1024), 1),
                                     ((8, 512, 1024), 3), ((8, 512, 1024), 4),
                                     ((8, 512, 1024), 17), ((1, 4096, 640), 2),
                                     ((2, 64, 40000), 2), ((2, 40000, 72), 2)]
                         + [(slab, 2) for slab in LM_SLABS])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_kernels_match_plain(shape, r, offset):
    """Both kernels within atol/rtol of the plain version, on aligned
    inputs and on views one float past an aligned start, and bit for bit
    the same on a second call."""
    _cuda()
    m_np, q_np, p_np = _inputs(shape, r, seed=1)
    m = _offset_view(m_np, offset)
    q, p = (torch.tensor(a, device="cuda") for a in (q_np, p_np))
    for kern, plain, f in ((lowrank.lowrank_project, ref.lowrank_project, q),
                           (lowrank.lowrank_backproject, ref.lowrank_backproject, p)):
        got = kern(m, f)
        torch.testing.assert_close(got, plain(m, f), atol=ATOL, rtol=RTOL)
        assert torch.equal(got, kern(m, f))
