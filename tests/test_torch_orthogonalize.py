"""The port's orthogonalizers against the JAX package's: Gram-Schmidt,
CholeskyQR2 and the Gram-Schmidt → CholeskyQR2 fallback, including
all-zero and rank-deficient columns, near-rank-deficient draws, the
reference's ill-conditioned fixture and batch elements whose factorization
fails.

Tolerances (fp32, outputs of norm ≤ 1): Gram-Schmidt atol 1e-5 (different
reduction orders).  CholeskyQR2 atol 1e-6 on well-conditioned input
(measured ≤ 7.5e-8: the two packages' GEMM, Cholesky and triangular solve
round differently by an ulp or so) and 1e-4 on the κ ≈ 1e4 fixture
(measured 2.1e-5; differences grow as κ·ulp ≈ 1.2e-3).  An exactly
dependent column has no determined direction under CholeskyQR2: the jitter
swamps it and both packages leave a near-zero noise column there, so that
column is held to its size and the span, not elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal env: deterministic fallback sampler
    from _hypothesis_fallback import given, settings, strategies as st

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


ULP = float(np.finfo(np.float32).eps)
GS_TOL = 1024.0 * ULP            # gs_cholqr's projector test
CHOL_ATOL = 1e-6
ILL_ATOL = 1e-4


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


def _ill_conditioned():
    """The reference's fixture (tests/test_orthogonalize.py): col3 ≈ col0
    + 1e-4·noise, κ ≈ 1e4."""
    u = jax.random.normal(jax.random.key(12), (64, 4))
    p = u @ jnp.diag(jnp.array([1.0, 1.0, 1.0, 1e-4]))
    return np.asarray(p.at[:, 3].add(p[:, 0]))


def _near_deficient(seed, n, r, rank, noise):
    """tests/test_properties.py's construction: columns span only ``rank``
    directions plus noise (κ(P) → 1/noise)."""
    rng = np.random.RandomState(seed % 2**31)
    base = rng.randn(n, rank).astype(np.float32)
    mix = rng.randn(rank, r).astype(np.float32)
    return base @ mix + noise * rng.randn(n, r).astype(np.float32)


def _both(name, p):
    want = np.asarray(getattr(jorth, name)(jnp.array(p)))
    got = getattr(orth, name)(torch.tensor(p)).numpy()
    return got, want


def _reference_projector_error(p):
    q = jorth.gram_schmidt(jnp.array(p))
    gram = jnp.einsum("...nr,...ns->...rs", q, q)
    return np.asarray(jnp.max(jnp.abs(gram @ gram - gram), axis=(-2, -1)))


CASES = list(_cases())
IDS = [n for n, _ in CASES]


@pytest.mark.parametrize("name,p", CASES, ids=IDS)
def test_gram_schmidt_matches_reference(name, p):
    want = np.asarray(jorth.gram_schmidt(jnp.asarray(p)))
    got = orth.gram_schmidt(torch.tensor(p)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # exact-zero columns stay exactly zero
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("fn", ["cholesky_qr", "gs_cholqr"])
@pytest.mark.parametrize("name,p", CASES, ids=IDS)
def test_cholesky_orthogonalizers_match_reference(name, p, fn):
    got, want = _both(fn, p)
    assert got.shape == want.shape == p.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    if name == "all_zero":
        # the jitter is eps alone: an all-zero P gives an all-zero P̂
        assert not got.any() and not want.any()
    if name == "rank_deficient" and fn == "cholesky_qr":
        # column 2 = 3·column 0: its output column is jitter-swamped noise
        np.testing.assert_allclose(got[..., :2], want[..., :2],
                                   atol=CHOL_ATOL, rtol=0)
        for x in (got, want):
            assert np.linalg.norm(x[..., 2], axis=-1).max() < 1e-2
            proj = np.einsum("...nr,...mr,...ms->...ns", x, x, p)
            np.testing.assert_allclose(proj, p, atol=1e-4, rtol=0)
        return
    np.testing.assert_allclose(got, want, atol=CHOL_ATOL, rtol=0)


@pytest.mark.parametrize("fn", ["cholesky_qr", "gs_cholqr"])
def test_ill_conditioned_fixture_matches_reference(fn):
    p = _ill_conditioned()
    got, want = _both(fn, p)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ILL_ATOL, rtol=0)
    # the reference property test's bounds (the jitter leaves the weak
    # direction's column a little short of unit norm)
    gram = got.T @ got
    assert np.max(np.abs(gram - np.diag(np.diag(gram)))) < 5e-2
    assert np.all(np.diag(gram) < 1.0 + 1e-4)


def test_zero_row_padding_is_exact():
    """Bucket padding: zero rows change no bit of the unpadded rows."""
    p = np.random.default_rng(3).standard_normal((3, 40, 4)).astype(np.float32)
    padded = np.concatenate([p, np.zeros((3, 9, 4), np.float32)], axis=1)
    for fn in ("cholesky_qr", "gs_cholqr"):
        f = orth.get_orthogonalizer(fn)
        a = f(torch.tensor(padded))
        assert torch.equal(a[:, :40], f(torch.tensor(p)))
        assert not a[:, 40:].any()


@pytest.mark.parametrize("shape", [(40, 3), (3, 40, 2), (2, 3, 40, 4)])
@pytest.mark.parametrize("fn", sorted(orth.ORTHOGONALIZERS))
def test_outputs_are_row_major(fn, shape):
    """Every orthogonalizer returns a contiguous P̂: the low-rank kernels
    read it row-major and raise on a strided one (the triangular solve
    alone returns it column-major)."""
    p = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    q = orth.get_orthogonalizer(fn)(p)
    assert q.shape == p.shape and q.is_contiguous()


@settings(deadline=None, max_examples=20)
@given(seed=st.integers(min_value=0, max_value=10**6),
       r=st.integers(min_value=2, max_value=8),
       deficiency=st.integers(min_value=1, max_value=8))
def test_orthogonalizers_near_rank_deficient(seed, r, deficiency):
    """The reference property test's bounds, on the port: finite,
    off-diagonal Gram below 5e-2, diagonal at most 1 + 1e-4.  Elementwise
    agreement is not expected: the noise directions are ill-determined."""
    rank = max(1, r - deficiency)
    p = _near_deficient(seed, n=64, r=r, rank=rank, noise=1e-3)
    for fn in ("gram_schmidt", "cholesky_qr", "gs_cholqr"):
        q = orth.get_orthogonalizer(fn)(torch.tensor(p)).numpy()
        assert np.isfinite(q).all(), fn
        gram = q.T @ q
        off = gram - np.diag(np.diag(gram))
        assert np.max(np.abs(off)) < 5e-2, (fn, gram)
        assert np.all(np.diag(gram) < 1.0 + 1e-4), (fn, gram)


def test_failed_factorization_gives_reference_nan_pattern():
    """A Gram matrix that is not positive definite: ``cholesky_or_nan``
    does not raise and gives ``jnp.linalg.cholesky``'s pattern (NaN on and
    below the diagonal of that element, the others within an ulp)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 10, 3)).astype(np.float32)
    grams = np.einsum("bnr,bns->brs", a, a) + np.eye(3, dtype=np.float32)
    grams[2] = np.array([[1, 2, 0], [2, 1, 0], [0, 0, 1]], np.float32)
    want = np.asarray(jnp.linalg.cholesky(jnp.array(grams)))
    got = orth.cholesky_or_nan(torch.tensor(grams)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2][np.tril_indices(3)]).all()
    ok = [0, 1, 3]
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["gram_schmidt", "cholesky_qr", "gs_cholqr"])
def test_non_finite_element_is_contained(fn):
    """One NaN and one inf element in a batch: no exception, the
    reference's NaN/finite pattern per element, and every other element
    bit-equal to the port's call on it alone and within tolerance of the
    reference."""
    p = np.random.default_rng(2).standard_normal((5, 30, 3)).astype(np.float32)
    p[1, 0, 0] = np.nan
    p[3, 3, 1] = np.inf
    got, want = _both(fn, p)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert [np.isfinite(x).all() for x in got] == [True, False, True, False, True]
    f = orth.get_orthogonalizer(fn)
    for i in (0, 2, 4):
        assert np.array_equal(got[i], f(torch.tensor(p[i])).numpy()), i
        np.testing.assert_allclose(got[i], want[i], atol=CHOL_ATOL, rtol=0)


def test_overflowing_gram_is_nan_in_the_port():
    """A finite P whose Gram overflows to inf: the port's factorization
    fails and that element is NaN; the reference's CPU Cholesky returns an
    infinite diagonal there instead and gives all zeros (ROADMAP C3).  The
    other elements are untouched in both."""
    p = np.random.default_rng(4).standard_normal((3, 30, 3)).astype(np.float32)
    p[1] *= np.float32(1e20)
    got, want = _both("cholesky_qr", p)
    assert np.isnan(got[1]).all() and not np.isnan(got[[0, 2]]).any()
    assert not want[1].any()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=CHOL_ATOL, rtol=0)


def _choice_inputs():
    """(wide, near): inputs whose Gram-Schmidt projector error lies far
    from ``GS_TOL`` (random draws and near-deficient draws at noise 1e-2:
    kept; noise 1e-5 and the κ ≈ 1e4 fixture: replaced; noise 1e-6: the
    weak column is zeroed, kept), and the reference property test's noise
    1e-3, whose errors straddle ``GS_TOL`` (within ×2 of it)."""
    rng = np.random.default_rng(5)
    well = rng.standard_normal((3, 64, 4)).astype(np.float32)
    draws = lambda noise, rank: np.stack(
        [_near_deficient(s, 64, 4, rank, noise) for s in range(3)])
    ill = _ill_conditioned()[None]
    wide = np.concatenate([well, draws(1e-2, 2), draws(1e-5, 1), ill,
                           draws(1e-6, 3)])
    return wide, draws(1e-3, 2)


def _choices(p):
    """(port choices, reference choices, port errors, reference errors):
    True where gs_cholqr keeps Gram-Schmidt."""
    err = orth.projector_error(orth.gram_schmidt(torch.tensor(p))).numpy()
    err_r = _reference_projector_error(p)
    return err <= GS_TOL, err_r <= GS_TOL, err, err_r


def _print_margins(label, keep, keep_r, err, err_r):
    for i, (e, er) in enumerate(zip(err, err_r)):
        print(f"{label} {i}: keep port {keep[i]} ref {keep_r[i]}, error "
              f"port {e:.3e} ref {er:.3e}, tol {GS_TOL:.3e}, margin "
              f"×{max(e, GS_TOL) / max(min(e, GS_TOL), 1e-30):.1f}")


def test_gs_cholqr_choice_matches_reference():
    """Per element, on the wide-margin inputs both packages keep
    Gram-Schmidt or both take CholeskyQR2; kept elements are bit-equal to
    the port's own Gram-Schmidt, replaced ones to its own CholeskyQR2.
    Near the threshold (noise 1e-3) the two packages' rounding decides and
    their choices may differ: those are printed with their margins, and
    held only to the port's own rule."""
    wide, near = _choice_inputs()
    for label, p in (("wide", wide), ("near", near)):
        keep, keep_r, err, err_r = _choices(p)
        _print_margins(label, keep, keep_r, err, err_r)
        t = torch.tensor(p)
        got = orth.gs_cholqr(t)
        assert torch.equal(got[keep], orth.gram_schmidt(t)[keep])
        assert torch.equal(got[~keep], orth.cholesky_qr(t)[~keep])
        if label == "near":
            print(f"near: {int((keep != keep_r).sum())} of {len(keep)} "
                  f"choices differ from the reference's")
            continue
        np.testing.assert_array_equal(keep, keep_r)
        assert keep.any() and not keep.all()   # both branches are exercised
        want = np.asarray(jorth.gs_cholqr(jnp.array(p)))
        np.testing.assert_allclose(got[keep].numpy(), want[keep],
                                   atol=1e-5, rtol=0)
        # a replaced element is ill-conditioned: the packages differ as
        # κ·ulp (measured 2.1e-5 at κ ≈ 1e4, 1.0e-3 on the noise-1e-5 draws)
        for i in np.flatnonzero(~keep):
            np.testing.assert_allclose(got[i].numpy(), want[i], rtol=0,
                                       atol=np.linalg.cond(p[i]) * ULP)


def test_unported_orthogonalizers_raise():
    """Every name of the reference resolves (all three are ported); an
    unknown name still raises ValueError."""
    assert sorted(orth.ORTHOGONALIZERS) == sorted(jorth.ORTHOGONALIZERS)
    for name in jorth.ORTHOGONALIZERS:
        assert orth.get_orthogonalizer(name) is orth.ORTHOGONALIZERS[name]
    with pytest.raises(ValueError):
        orth.get_orthogonalizer("householder")


if __name__ == "__main__":
    for label, p in zip(("wide", "near"), _choice_inputs()):
        _print_margins(label, *_choices(p))
