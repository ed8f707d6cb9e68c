"""Every registered architecture's training loss, held against the JAX
package on the CPU, and the port's command line on each:

* ``loss_fn`` of every reduced configuration (``lm_loss`` and
  ``moe_aux``, and the total the gradient is taken of) and its gradients
  from the same parameters (the reference's draw, carried over by
  ``repro_torch.bridge``) on the same batch; reduced LLaVA-NeXT with 8
  patch embeddings as the sequence prefix and without patches;
* ``remat=True`` gives the same loss and gradients bit for bit as
  ``remat=False`` (reduced Jamba, every slot kind), and a sliding window
  on reduced Llama-3-8B trains against the reference's;
* ``python -m repro_torch.launch.train --arch <id>`` trains one step on
  the CPU for every id.

Tolerances: losses rtol 1e-5; gradients within ``GRAD_RTOL`` = 1e-5 of
each leaf's largest magnitude, Mamba-2's per-head ``A_log``, ``D`` and
``dt_bias`` within 1e-4 (``SCAN_VECTOR_GRAD_RTOL``, as in
``tests/test_torch_arch_models.py``).  ``python
tests/test_torch_arch_loss.py [--port-draw]`` prints the gaps.
"""

import functools
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import model as jmodel
from repro_torch import bridge, tree
from repro_torch.configs import base
from repro_torch.launch import train
from repro_torch.models import model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LOSS_RTOL, GRAD_RTOL, SCAN_VECTOR_GRAD_RTOL = 1e-5, 1e-5, 1e-4
B, S, PATCHES, Q_CHUNK = 2, 32, 8, 16
CASES = [(a, False) for a in base.ARCH_IDS] + [("llava_next_34b", True)]


def _batch(cfg, patches, seed=0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                       # masked positions
    batch = {"tokens": toks[:, :-1], "labels": labels}
    if patches:
        batch["patches"] = r.standard_normal(
            (B, PATCHES, cfg.frontend_dim)).astype(np.float32)
    return batch


@functools.cache
def _reference_params(arch):
    """The reference's initial parameters of the reduced ``arch`` as numpy
    arrays, drawn once a module (the draw runs op by op: seconds a
    model)."""
    return jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.key(0), jbase.get_config(arch, True)))


def _pair(arch, patches, window=0, port_draw=False):
    """Both packages' (total, lm_loss, moe_aux) and gradients of the total
    from the reference's initial parameters (``port_draw``: the port's)."""
    jcfg, cfg = jbase.get_config(arch, True), base.get_config(arch, True)
    params_np = (bridge.to_numpy(model.init(cfg, torch.Generator().manual_seed(0)))
                 if port_draw else _reference_params(arch))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    batch = _batch(cfg, patches)

    def jloss(p):
        return jmodel.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                              jcfg, q_chunk=Q_CHUNK, window=window, remat=False)

    (jtotal, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    params = tree.map(lambda x: x.requires_grad_(True), bridge.to_torch(params_np))
    total, m = model.loss_fn(params, {k: torch.tensor(v) for k, v in batch.items()},
                             cfg, q_chunk=Q_CHUNK, window=window)
    grads = torch.autograd.grad(total, tree.leaves(params), allow_unused=True,
                                materialize_grads=True)
    gaps = {path: float(np.abs(g.numpy() - np.asarray(w)).max()
                        / max(np.abs(np.asarray(w)).max(), 1e-30))
            for (path, _), g, w in zip(tree.items(params), grads,
                                       jax.tree_util.tree_leaves(jg))}
    return ((total.item(), m["lm_loss"].item(), m["moe_aux"].item()),
            (float(jtotal), float(jm["lm_loss"]), float(jm["moe_aux"])), gaps)


def _limit(path):
    return SCAN_VECTOR_GRAD_RTOL if path[-1] in ("A_log", "D", "dt_bias") else GRAD_RTOL


@pytest.mark.parametrize("arch,patches", CASES,
                         ids=[a + ("-patches" if p else "") for a, p in CASES])
def test_loss_and_grads_match_reference(arch, patches):
    got, want, gaps = _pair(arch, patches)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7)
    has_moe = model.has_moe(base.get_config(arch, True))
    assert (got[2] > 0) == has_moe
    for path, gap in gaps.items():
        assert gap <= _limit(path), (path, gap)
    if arch == "llava_next_34b" and not patches:
        # without patches the frontend's projection takes no gradient
        assert gaps[("frontend_proj",)] == 0.0


def test_window_matches_reference():
    got, want, gaps = _pair("llama3_8b", False, window=12)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert max(gaps.values()) <= GRAD_RTOL


def test_remat_is_bit_equal():
    cfg = base.get_config("jamba_v01_52b", True)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.tensor(v) for k, v in _batch(cfg, False).items()}
    runs = [train.local_grads(cfg, params, batch, q_chunk=Q_CHUNK, device="cpu",
                              remat=remat)
            for remat in (False, True)]
    (g0, m0), (g1, m1) = runs
    assert torch.equal(m0["lm_loss"], m1["lm_loss"])
    assert torch.equal(m0["moe_aux"], m1["moe_aux"])
    for path, a, b in zip(tree.items(params), g0, g1):
        assert torch.equal(a, b), path[0]


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_cli_trains_every_architecture(capsys, arch):
    """One step of the reduced model on the CPU (S = 32, a multiple of
    Mamba-2's SSD chunk); ``main`` returns and prints the final loss."""
    train.main(["--arch", arch, "--steps", "1", "--batch", "2", "--seq", "33",
                "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"final lm_loss=(\S+) hex=", out)
    assert m and np.isfinite(float(m.group(1))), out


if __name__ == "__main__":
    # --port-draw: the same from the port's draw of the parameters
    for arch, patches in CASES:
        got, want, gaps = _pair(arch, patches, port_draw="--port-draw" in sys.argv)
        worst = max(gaps, key=gaps.get)
        print(arch, "patches" if patches else "", "losses", got, want,
              "worst grad gap", worst, gaps[worst])
    sys.exit(0)
