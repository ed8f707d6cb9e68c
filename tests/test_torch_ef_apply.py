"""The fused error-feedback apply: the port's plain ``ef_apply`` and its CPU
dispatch against ``repro.kernels.ref.ef_apply`` and the Pallas kernel of
``repro.kernels.ef_apply`` (interpret mode, as ``tests/test_kernels.py``
runs it), on the same numpy inputs.

Tolerance: atol/rtol 1e-4, the tolerance ``tests/test_kernels.py`` holds
the Pallas kernel to against its reference (float32; Δ' = P̂ Qᵀ is summed
over r in different orders).  The CUDA kernel is held against the plain
version by the ``cuda``-marked tests (skipped without a card) and by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ef_apply, ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LR, LAM = 0.05, 0.9
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(lead, n, m, r, seed):
    rng = np.random.default_rng(seed)
    draw = lambda *s: rng.standard_normal(lead + s).astype(np.float32)
    return draw(n, m), draw(n, m), draw(n, r), draw(m, r)


def _check(arrays, pallas: bool):
    tx = [torch.tensor(a) for a in arrays]
    want = jref.ef_apply(*map(jnp.asarray, arrays), LR, LAM)
    got_ref = ref.ef_apply(*tx, LR, LAM)
    got_ops = ops.ef_apply(*tx, LR, LAM)
    for got in (got_ref, got_ops):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if pallas:
        kern = jops.ef_apply(*map(jnp.asarray, arrays), LR, LAM,
                             block_n=64, block_m=64)
        for g, w in zip(got_ops, kern):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@settings(deadline=None, max_examples=12)
@given(n=st.integers(1, 200), m=st.integers(1, 200), r=st.integers(1, 4),
       batched=st.booleans(), seed=st.integers(0, 10_000))
def test_ef_apply_matches_reference_and_pallas(n, m, r, batched, seed):
    _check(_inputs((3,) if batched else (), n, m, r, seed), pallas=True)


@pytest.mark.parametrize("lead,n,m,r", [
    ((), 1, 1, 1), ((), 7, 255, 2), ((3,), 255, 7, 32), ((), 33, 65, 129),
    ((2, 2), 16, 24, 3)])
def test_ef_apply_ragged_and_large_rank(lead, n, m, r):
    """Ragged n and m, r beyond the TPU kernel's 128 lanes, two batch dims."""
    _check(_inputs(lead, n, m, r, seed=n + m + r), pallas=len(lead) < 2)


def test_ef_apply_returns_new_tensors():
    x, mom, p, q = (torch.tensor(a) for a in _inputs((), 5, 6, 2, seed=0))
    x0, mom0 = x.clone(), mom.clone()
    new_x, new_mom = ops.ef_apply(x, mom, p, q, LR, LAM)
    assert torch.equal(x, x0) and torch.equal(mom, mom0)
    delta = p @ q.T
    assert torch.equal(new_mom, LAM * mom + delta)
    assert torch.equal(new_x, x - LR * (delta + new_mom))


def test_cpu_dispatch_never_launches():
    ef_apply.reset_launches()
    ops.ef_apply(*(torch.tensor(a) for a in _inputs((2,), 4, 5, 1, seed=1)),
                 LR, LAM)
    assert ef_apply.LAUNCHES == {"ef_apply": 0}


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises; it never computes on the CPU."""
    ef_apply.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        ef_apply.ef_apply(*(torch.tensor(a) for a in _inputs((), 4, 5, 1, 2)),
                          LR, LAM)
    assert ef_apply.LAUNCHES == {"ef_apply": 0}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n,m,r", [
    ((), 1, 1, 1), ((), 1000, 1023, 2), ((3,), 255, 7, 4), ((), 7, 1024, 129),
    ((4,), 4096, 1024, 2), ((2,), 33, 257, 32)])
def test_cuda_ef_apply_matches_plain(lead, n, m, r):
    dev = _cuda()
    x, mom, p, q = (torch.tensor(a, device=dev)
                    for a in _inputs(lead, n, m, r, seed=n * m))
    before = ef_apply.LAUNCHES["ef_apply"]
    got = ops.ef_apply(x, mom, p, q, LR, LAM)
    assert ef_apply.LAUNCHES["ef_apply"] == before + 1
    for g, w in zip(got, ref.ef_apply(x, mom, p, q, LR, LAM)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
def test_cuda_ef_apply_unaligned_and_refusals():
    """A contiguous view 4 bytes past an aligned start takes the scalar
    path; non-contiguous and non-float32 inputs raise."""
    dev = _cuda()
    n, m, r = 64, 256, 2
    x, mom, p, q = (torch.tensor(a, device=dev) for a in _inputs((), n, m, r, 3))
    xs = torch.empty(n * m + 1, device=dev)[1:].view(n, m).copy_(x)
    for g, w in zip(ops.ef_apply(xs, mom, p, q, LR, LAM),
                    ref.ef_apply(x, mom, p, q, LR, LAM)):
        torch.testing.assert_close(g, w, **TOL)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ef_apply(x.T, mom.T, q, p, LR, LAM)
    with pytest.raises(TypeError, match="float32"):
        ops.ef_apply(x.double(), mom.double(), p.double(), q.double(), LR, LAM)
