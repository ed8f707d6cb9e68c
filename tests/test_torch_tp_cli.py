"""The training CLI on a (data, model) grid: ``python -m
repro_torch.launch.train --device cpu`` under ``torchrun`` with 4 CPU
processes, against the JAX package's CLI on 4 host devices.

* Both take the JAX CLI's grid rule, (2, 2) for four: the port prints its
  grid, the reference's ``jax.make_mesh`` gets four devices.  Both start
  from the same state, the one the port's CLI draws (seed 0, heads and
  vocabulary padded to the model size): the reference's CLI runs as
  ``python tests/test_torch_tp_cli.py --reference-cli <state> <flags>``,
  its ``init_state`` handing out that state.  (Its ``--resume`` of a
  (2, 2) envelope fails on jax 0.9.0 in the donated step, as a fresh
  array layout does.)  The final ``lm_loss`` agrees within rtol 1e-5 (the
  loss tolerance of ``tests/test_torch_dist.py``).
* ``--ckpt-dir``, ``--resume`` and ``--rank-schedule`` on a model axis of
  2 raise ``NotImplementedError`` naming item 14 before any step, in
  ``check_model_axis_options`` and through the CLI under ``torchrun``.
"""

import os
import pickle
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import llama3_8b
from repro_torch.core import compressors
from repro_torch.launch import train
from repro_torch.models import model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
SMALL = ["--batch", "4", "--seq", "32"]
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.timeout(240)


def _port_initial_state():
    """The global state the port's CLI draws on a (2, 2) grid:
    ``make_train_step(..., mesh=...)``'s ``init_state`` with a generator
    seeded 0 (parameters at ``model_shards=2``, then the factors)."""
    cfg = llama3_8b.reduced_config()
    gen = torch.Generator("cpu").manual_seed(0)
    params = model.init(cfg, gen, "cpu", model_shards=2)
    comp = compressors.PowerSGDCompressor(rank=2).init(params, model.mspecs(cfg),
                                                       gen)
    return bridge.to_numpy(params), bridge.to_numpy(comp)


def _reference_cli(path, argv):
    """The reference's CLI (its ``main``: grid rule, loop, printed lines)
    with its ``init_state`` handing out the global state pickled at
    ``path`` instead of its own draws; run in a process of its own.  It
    prints the grid its CLI built."""
    import jax
    import jax.numpy as jnp
    from repro.launch import train as jtrain

    with open(path, "rb") as f:
        params, comp = pickle.load(f)
    make = jtrain.make_train_step

    def make_train_step(cfg, mesh, hyper, compressor=None):
        step, abstract, _ = make(cfg, mesh, hyper, compressor)
        print(f"reference mesh (data, model) = "
              f"({mesh.shape['data']}, {mesh.shape['model']})")

        def init_state(key):
            p = jax.tree_util.tree_map(jnp.array, params)
            zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
            d = mesh.shape["data"]
            return p, jtrain.EFState(
                error=jax.tree_util.tree_map(
                    lambda x: jnp.zeros((d,) + x.shape, x.dtype), p),
                momentum=zeros(p),
                comp=jax.tree_util.tree_map(jnp.array, comp),
                step=jnp.zeros((), jnp.int32), inflight=None)
        return step, abstract, init_state

    jtrain.make_train_step = make_train_step
    sys.argv = ["repro.launch.train", *argv]
    jtrain.main()


def _torchrun(cwd, *argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", *SMALL, *argv], cwd=str(cwd), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


# the guard runs before any step: one torchrun shows it in the CLI, and
# test_model_axis_options_raise_before_any_step holds each flag
GUARDED = ["--rank-schedule", "1@0,2@2", "--ckpt-dir", "ck"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference CLI (from the port's initial state), the port's
    CLI on 4 processes, and the port's CLI under guarded options, all at
    once.  {name: (returncode, stdout, stderr)}."""
    tmp = tmp_path_factory.mktemp("tp_cli")
    with open(tmp / "state.pkl", "wb") as f:
        pickle.dump(_port_initial_state(), f)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {"reference": subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference-cli",
         str(tmp / "state.pkl"), "--steps", str(STEPS), *SMALL], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    procs["port"] = _torchrun(tmp, "--steps", str(STEPS))
    procs["guarded"] = _torchrun(tmp, "--steps", "1", *GUARDED)
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=200)
            out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _final_loss(stdout):
    m = re.search(r"final lm_loss=\S+ hex=(\S+)", stdout)
    assert m, stdout
    return float.fromhex(m.group(1))


def test_both_clis_build_the_2x2_grid(runs):
    rc, out, err = runs["port"]
    assert rc == 0, out + err
    assert "mesh (data, model) = (2, 2)" in out
    assert out.count("final lm_loss") == 1          # printed by rank 0 only
    rc, out, err = runs["reference"]
    assert rc == 0, out + err
    assert "reference mesh (data, model) = (2, 2)" in out


def test_final_loss_matches_reference(runs):
    port, ref = runs["port"][1], runs["reference"][1]
    np.testing.assert_allclose(_final_loss(port), _final_loss(ref),
                               rtol=LOSS_RTOL)
    first = lambda s: float(re.search(r"step    0 loss=(\S+)", s).group(1))
    assert first(port) == first(ref)      # the same start, to 4 decimals


def test_unported_options_raise_under_torchrun(runs):
    rc, out, err = runs["guarded"]
    assert rc != 0
    assert "NotImplementedError" in err and "item 14" in err, err[-2000:]
    assert "step    0" not in out


@pytest.mark.parametrize("flag", ["ckpt_dir", "resume", "rank_schedule"])
def test_model_axis_options_raise_before_any_step(flag):
    args = types.SimpleNamespace(ckpt_dir=None, resume=False, rank_schedule=None)
    setattr(args, flag, True if flag == "resume" else "x")
    with pytest.raises(NotImplementedError, match="item 14"):
        train.check_model_axis_options(args, 2)
    train.check_model_axis_options(args, 1)       # model size 1: unchanged


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--reference-cli":
        _reference_cli(sys.argv[2], sys.argv[3:])
