"""The port's low-rank products against the JAX package's Pallas kernels.

On the CPU, ``repro_torch.kernels.ops`` takes the plain PyTorch version; it
is held here against ``repro.kernels.ops`` run as ``tests/test_kernels.py``
runs it (Pallas in interpret mode).  Tolerance atol 1e-4, rtol 1e-4: fp32
with a different summation order.  The CUDA kernels themselves are held
against the plain version on the card by ``chip_smoke.py`` and by the
``cuda``-marked test below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, lowrank, ops, ref

ATOL = RTOL = 1e-4

# 2-D, 3-D and 4-D inputs, r from 1 to 8, ragged n and m
CASES = [((37, 53), 1), ((64, 128), 2), ((3, 45, 70), 3),
         ((2, 3, 33, 17), 4), ((5, 129, 31), 8), ((1, 300, 7), 5)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,r", [((3, 100, 64), 2), ((1000, 1023), 3),
                                     ((8, 512, 1024), 32)])
def test_cuda_kernels_match_plain(shape, r):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    m, q, p = (torch.tensor(a, device="cuda") for a in _inputs(shape, r, seed=1))
    torch.testing.assert_close(lowrank.lowrank_project(m, q),
                               ref.lowrank_project(m, q), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lowrank.lowrank_backproject(m, p),
                               ref.lowrank_backproject(m, p), atol=ATOL, rtol=RTOL)
