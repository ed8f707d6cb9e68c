"""The port's Gram-Schmidt against the JAX package's, including all-zero and
rank-deficient columns (exact-zero output columns, no NaN).  Tolerance
atol 1e-5: fp32 with different reduction orders, outputs of norm ≤ 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import orthogonalize as jorth
from repro_torch.core import orthogonalize as orth


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cases():
    rng = np.random.default_rng(0)
    yield "random", rng.standard_normal((3, 50, 4)).astype(np.float32)
    p = rng.standard_normal((2, 40, 3)).astype(np.float32)
    p[:, :, 1] = 0.0
    yield "zero_column", p
    p = rng.standard_normal((2, 40, 3)).astype(np.float32)
    p[:, :, 2] = 3.0 * p[:, :, 0]
    yield "rank_deficient", p
    yield "all_zero", np.zeros((1, 16, 2), np.float32)
    yield "tiny_scale", (1e-20 * rng.standard_normal((2, 30, 2))).astype(np.float32)
    yield "two_dim", rng.standard_normal((25, 5)).astype(np.float32)


@pytest.mark.parametrize("name,p", list(_cases()), ids=[n for n, _ in _cases()])
def test_gram_schmidt_matches_reference(name, p):
    want = np.asarray(jorth.gram_schmidt(jnp.asarray(p)))
    got = orth.gram_schmidt(torch.tensor(p)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # exact-zero columns stay exactly zero
    np.testing.assert_array_equal(got == 0, want == 0)


def test_unported_orthogonalizers_raise():
    for name in ("cholesky_qr", "gs_cholqr"):
        with pytest.raises(NotImplementedError, match="item 8"):
            orth.get_orthogonalizer(name)
    with pytest.raises(ValueError):
        orth.get_orthogonalizer("householder")
