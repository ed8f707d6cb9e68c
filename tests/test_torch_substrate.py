"""The port's synthetic images, batch sharding, CIFAR-10 schedule and
``SimMesh.run`` against the JAX package's (the twins of
``tests/test_substrate.py``).

* ``GaussianClusters`` batches are numpy copies: bit-equal to the
  reference's for the same seed, size and step.
* ``shard_batch`` slices equal the reference's.
* ``step_decay`` and ``paper_cifar_schedule`` are plain floats; the
  reference computes in float32, so they agree within rtol 1e-6.
* ``SimMesh.run`` equals the reference's ``vmap`` of a worker-local function
  (float32 on both sides, one reduction per worker: rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.simmesh import SimMesh as JSimMesh
from repro.data import synthetic as jdata
from repro.optim import schedules as jsched
from repro_torch.core.simmesh import SimMesh
from repro_torch.data import synthetic
from repro_torch.optim import schedules


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed,size,channels,classes", [
    (0, 8, 3, 4), (3, 32, 3, 10), (7, 5, 1, 2)])
def test_gaussian_clusters_bit_equal_reference(seed, size, channels, classes):
    kw = dict(num_classes=classes, image_size=size, channels=channels, seed=seed,
              noise=0.5)
    got, want = synthetic.GaussianClusters(**kw), jdata.GaussianClusters(**kw)
    np.testing.assert_array_equal(got._centers, want._centers)
    for step in (0, 1, 17):
        g, w = got.sample(6, step), want.sample(6, step)
        assert g["images"].shape == (6, size, size, channels)
        for k in ("images", "labels"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    for g, w, _ in zip(got.batches(3), want.batches(3), range(3)):
        np.testing.assert_array_equal(g["images"], w["images"])


def test_clusters_separable():
    data = synthetic.GaussianClusters(num_classes=4, image_size=8, seed=0, noise=0.3)
    batch = data.sample(256, step=0)
    x = batch["images"].reshape(256, -1)
    own = np.linalg.norm(x - data._centers[batch["labels"]], axis=1).mean()
    other = np.linalg.norm(x - data._centers[(batch["labels"] + 1) % 4], axis=1).mean()
    assert own < other


@pytest.mark.parametrize("worker,workers", [(0, 1), (1, 4), (3, 4), (1, 2)])
def test_shard_batch_equals_reference(worker, workers):
    b = {"tokens": np.arange(64).reshape(16, 4), "labels": np.arange(16)}
    got = synthetic.shard_batch(b, worker, workers)
    want = jdata.shard_batch(b, worker, workers)
    assert sorted(got) == sorted(want)
    for k in b:
        np.testing.assert_array_equal(got[k], want[k])


def test_shard_batch_refuses_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        synthetic.shard_batch({"x": np.zeros((6, 2))}, 0, 4)


@pytest.mark.parametrize("step", [0, 3, 9, 10, 11, 15, 16, 40])
def test_step_decay_equals_reference(step):
    got = schedules.step_decay(step, 0.8, (10, 15))
    want = float(jsched.step_decay(step, 0.8, (10, 15)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("step", [0, 25, 49, 50, 1499, 1500, 2499, 2500, 2600])
def test_paper_cifar_schedule_equals_reference(step):
    got = schedules.paper_cifar_schedule(step, 0.1, 16, steps_per_epoch=10)
    want = float(jsched.paper_cifar_schedule(step, 0.1, 16, steps_per_epoch=10))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_schedule_paper_recipe():
    lr = lambda s: schedules.paper_cifar_schedule(s, 0.1, 16, steps_per_epoch=10)
    assert abs(lr(0) - 0.1) < 1e-9          # starts at the 1-worker rate
    assert abs(lr(50) - 1.6) < 1e-9         # 16× after the warmup
    assert abs(lr(2600) - 0.016) < 1e-9     # /10 /10 after both decays


def test_simmesh_run_matches_reference_vmap():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    x = rng.standard_normal((4, 2, 5)).astype(np.float32)
    state = rng.standard_normal((4, 3)).astype(np.float32)

    def jfn(w, x, s):
        y = x @ w
        return {"y": y, "s": 0.9 * s + 0.1 * y.mean(0)}, jnp.sum(y)

    def fn(w, x, s):
        y = x @ w
        return {"y": y, "s": 0.9 * s + 0.1 * y.mean(0)}, torch.sum(y)

    want = JSimMesh(4).run(jfn, in_axes=(None, 0, 0))(w, x, state)
    got = SimMesh(4).run(fn, in_axes=(None, 0, 0))(
        torch.tensor(w), torch.tensor(x), torch.tensor(state))
    assert isinstance(got, tuple) and got[1].shape == (4,)
    for g, ww in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == ww.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), rtol=1e-6, atol=1e-7)


def test_simmesh_run_refuses_bad_in_axes():
    run = SimMesh(2).run(lambda a, b: a, in_axes=(0, 1))
    with pytest.raises(ValueError, match="in_axes"):
        run(torch.zeros(2), torch.zeros(2))
