"""The training CLI on a (data, model) grid: ``python -m
repro_torch.launch.train --device cpu`` under ``torchrun`` with 4 CPU
processes, against the JAX package's CLI on 4 host devices.

* Both take the JAX CLI's grid rule, (2, 2) for four: the port prints its
  grid, the reference's ``jax.make_mesh`` gets four devices.  Both start
  from the same state, the one the port's CLI draws (seed 0, heads and
  vocabulary padded to the model size): the reference's CLI runs as
  ``python tests/test_torch_tp_cli.py --reference-cli <state> <flags>``,
  its ``init_state`` handing out that state.  The final ``lm_loss`` after
  STEPS steps agrees within rtol 1e-5 (the loss tolerance of
  ``tests/test_torch_dist.py``).
* Checkpoints on the grid: the reference CLI saves its (2, 2) envelope at
  step 3 (``--ckpt-every 3``), and the port's CLI resumes it
  (``--resume``) to STEPS, within rtol 1e-5 of the reference's own final
  loss.  (The JAX CLI's own ``--resume`` of a (2, 2) envelope fails on
  jax 0.9.0 in the donated step, as a fresh array layout does.)
* ``--ckpt-dir``, ``--resume`` and ``--rank-schedule`` on a model axis of
  2: the port's CLI straight to STEPS under ``--rank-schedule
  1@0,2@2,4@4`` (growths at steps 2 and 4, the second after the save),
  saving at 3, against the step-3 envelope resumed to STEPS: the
  same ``hex=``, the same controller history and the same final envelope,
  byte for byte.
"""

import os
import pickle
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import llama3_8b
from repro_torch.core import compressors
from repro_torch.models import model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
SAVE_AT = 3
SCHEDULE = ["--rank-schedule", "1@0,2@2,4@4"]
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


def _envelope(directory, step):
    return f"{directory}/ckpt_{step:010d}.msgpack"


def _resume_from(src, dst):
    """A directory holding ``src``'s step-SAVE_AT envelope alone, for a
    ``--resume`` that continues from it."""
    dst.mkdir()
    shutil.copy(_envelope(src, SAVE_AT), _envelope(dst, SAVE_AT))
    return dst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference CLI (from the port's initial state, saving at SAVE_AT),
    the port's CLI on 4 processes, and the port's CLI under a rank schedule
    saving at SAVE_AT (``straight``); once their envelopes are written, the
    port's CLI resumes each (``from_reference``, ``resumed``).
    {name: (returncode, stdout, stderr)} and the directories."""
    tmp = tmp_path_factory.mktemp("tp_cli")
    with open(tmp / "state.pkl", "wb") as f:
        pickle.dump(_port_initial_state(), f)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    every = ["--ckpt-every", str(SAVE_AT)]
    procs = {"reference": subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference-cli",
         str(tmp / "state.pkl"), "--steps", str(STEPS), *SMALL,
         "--ckpt-dir", str(tmp / "reference"), *every], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    procs["port"] = _torchrun(tmp, "--steps", str(STEPS))
    procs["straight"] = _torchrun(tmp, "--steps", str(STEPS), *SCHEDULE,
                                  "--ckpt-dir", "straight", *every)
    # each resume starts once the envelope it continues is written
    then = {"straight": ("resumed", SCHEDULE),
            "reference": ("from_reference", [])}
    out = {}
    try:
        for name in ("straight", "reference", "port", "resumed",
                     "from_reference"):
            stdout, stderr = procs[name].communicate(timeout=200)
            out[name] = (procs[name].returncode, stdout, stderr)
            if name in then and procs[name].returncode == 0:
                nxt, flags = then[name]
                _resume_from(tmp / name, tmp / nxt)
                procs[nxt] = _torchrun(tmp, "--steps", str(STEPS), *flags,
                                       "--ckpt-dir", nxt, "--resume")
            elif name in then:
                return {"dir": tmp, **out}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {"dir": tmp, **out}


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
    """Once the item-14 guard; now the three options on a (2, 2) grid: the
    run straight to STEPS under a rank schedule (saving at SAVE_AT) and
    the step-SAVE_AT envelope resumed to STEPS give the same ``hex=``, the
    same controller history and the same final envelope, byte for byte."""
    from repro_torch.checkpoint import checkpoint_meta

    for name in ("straight", "resumed"):
        rc, out, err = runs[name]
        assert rc == 0, out + err
    straight, resumed = runs["straight"][1], runs["resumed"][1]
    assert f"resumed from step {SAVE_AT}" in resumed
    assert "step    0" not in resumed
    assert (re.search(r"hex=(\S+)", straight).group(1)
            == re.search(r"hex=(\S+)", resumed).group(1))
    metas = [checkpoint_meta(str(runs["dir"] / n), STEPS)
             for n in ("straight", "resumed")]
    assert metas[0]["controller"] == metas[1]["controller"]
    assert metas[0]["controller"]["history"] == [[0, 1], [2, 2], [4, 4]]
    with open(_envelope(runs["dir"] / "straight", STEPS), "rb") as f:
        want = f.read()
    with open(_envelope(runs["dir"] / "resumed", STEPS), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("flag", ["ckpt_dir", "resume", "rank_schedule"])
def test_model_axis_options_raise_before_any_step(runs, flag):
    """Once the item-14 guard per flag; now each flag's work on a model axis
    of 2: ``--ckpt-dir`` writes envelopes of the grid (degree 2, its
    ``mesh_shape``, each model-LOCAL factor stacked per model rank),
    ``--resume`` continues the port's and the reference's, and
    ``--rank-schedule`` switches at its milestones."""
    from repro_torch.checkpoint import checkpoint_meta, load_envelope

    if flag == "ckpt_dir":
        for step in (SAVE_AT, STEPS):
            meta = checkpoint_meta(str(runs["dir"] / "straight"), step)
            assert meta["model_axis_size"] == 2
            assert meta["mesh_shape"] == {"data": 2, "model": 2}
        leaves = {d["path"]: d for d in load_envelope(
            str(runs["dir"] / "straight"), SAVE_AT)["leaves"]}
        assert leaves["['ef'].comp['embed']"]["shape"][0] == 2
        assert leaves["['params']['embed']"]["shape"] == [1024, 256]
    elif flag == "resume":
        for name in ("resumed", "from_reference"):
            rc, out, err = runs[name]
            assert rc == 0 and f"resumed from step {SAVE_AT}" in out, out + err
    else:
        out = runs["straight"][1]
        assert "step    2 rank -> 2" in out and "step    4 rank -> 4" in out


def test_port_resumes_reference_envelope(runs):
    """The reference CLI's (2, 2) envelope of step SAVE_AT, resumed by the
    port's CLI to STEPS: the reference's own final loss within
    LOSS_RTOL."""
    rc, out, err = runs["from_reference"]
    assert rc == 0, out + err
    assert "mesh (data, model) = (2, 2)" in out
    np.testing.assert_allclose(_final_loss(out), _final_loss(runs["reference"][1]),
                               rtol=LOSS_RTOL)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--reference-cli":
        _reference_cli(sys.argv[2], sys.argv[3:])
