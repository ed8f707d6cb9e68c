"""The port's training CLI, ``python -m repro_torch.launch.train``
(``repro_torch.launch.train.main``), on the CPU: one process, a one-rank
gloo group made by ``main`` itself.

* A run stopped and resumed (``--resume``) ends on the same ``hex=`` as one
  that never stopped, at a fixed rank and mid-staircase; and so under
  ``torchrun`` with two CPU workers, whose error buffers the envelope
  stacks ``(2, ...)`` and hands back to each rank.
* Each resume guard's ``SystemExit`` text, as the JAX package's CLI words
  it: ``--ckpt-every`` or ``--resume`` without ``--ckpt-dir``, and a
  checkpoint of another rank schedule, staleness, wire dtype or data
  cursor.
* ``--staleness one_step`` trains (the case keeps its id, ``item 12``),
  and so does ``--sync-mode broadcast`` (``item 13``), on the plain run's
  ``hex=`` at one rank; another architecture, reduced Mamba2-1.3B,
  trains one step (``item 15``, its training half ported).
* ``--staleness one_step`` stopped and resumed ends on the straight run's
  ``hex=``, the envelope carrying the in-flight aggregate.
* Across packages: the JAX package's CLI (a process of its own, one CPU
  device) writes an envelope at step 4 and runs on to 6, synchronous and
  under ``--staleness one_step`` (the two processes at once); the port's
  CLI resumes each step-4 envelope to 6 and ends within the tolerances of
  ``tests/test_torch_train.py`` (loss rtol 1e-5, parameters atol 2e-6).
"""

import os
import re
import shutil
import subprocess
import sys
import zlib

import msgpack
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro_torch.launch import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--batch", "4", "--seq", "32", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cli(capsys, *argv):
    """``main(argv)`` at the small size; its standard output."""
    capsys.readouterr()
    train.main([*SMALL, *argv])
    assert not tdist.is_initialized()   # the group main made is gone
    return capsys.readouterr().out


def final_hex(out):
    m = re.search(r"final lm_loss=\S+ hex=(\S+)", out)
    assert m, out
    return m.group(1)


@pytest.mark.parametrize("schedule", [None, "1@0,2@2,4@5"],
                         ids=["fixed", "staircase"])
def test_resume_ends_on_the_same_hex(tmp_path, capsys, schedule):
    sched = [] if schedule is None else ["--rank-schedule", schedule]
    straight = cli(capsys, "--steps", "8", "--ckpt-dir", str(tmp_path / "a"), *sched)
    head = cli(capsys, "--steps", "4", "--ckpt-dir", str(tmp_path / "b"),
               "--ckpt-every", "2", "--ckpt-keep", "2", *sched)
    assert "step    1 checkpoint ->" in head and "final checkpoint ->" in head
    assert sorted(os.listdir(tmp_path / "b")) == ["ckpt_0000000002.msgpack",
                                                  "ckpt_0000000004.msgpack"]
    tail = cli(capsys, "--steps", "8", "--ckpt-dir", str(tmp_path / "b"),
               "--resume", *sched)
    assert "resumed from step 4" in tail
    assert final_hex(tail) == final_hex(straight)
    if schedule:
        assert "step    5 rank -> 4" in tail and "step    5 rank -> 4" in straight
        assert "step    2 rank -> 2" in head


def torchrun(tmp_path, *argv):
    """The CLI under ``torchrun`` with two CPU processes (gloo); its
    standard output."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *SMALL,
         *argv], cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_two_workers_resume_on_the_same_hex(tmp_path):
    straight = torchrun(tmp_path, "--steps", "6", "--ckpt-dir", str(tmp_path / "a"))
    torchrun(tmp_path, "--steps", "3", "--ckpt-dir", str(tmp_path / "b"))
    payload = msgpack.unpackb(open(tmp_path / "b" / "ckpt_0000000003.msgpack",
                                   "rb").read(), raw=False)
    assert payload["meta"]["workers"] == 2
    assert payload["meta"]["mesh_shape"] == {"data": 2, "model": 1}
    embed = next(d for d in payload["leaves"] if d["path"] == "['ef'].error['embed']")
    rows = np.frombuffer(embed["data"], "<f4").reshape(embed["shape"])
    assert rows.shape[0] == 2 and not np.array_equal(rows[0], rows[1])
    tail = torchrun(tmp_path, "--steps", "6", "--ckpt-dir", str(tmp_path / "b"),
                    "--resume")
    assert "resumed from step 3" in tail and tail.count("final lm_loss") == 1
    assert final_hex(tail) == final_hex(straight)


@pytest.fixture(scope="module")
def envelope(tmp_path_factory):
    """A port envelope at step 2 (no schedule, the auto wire)."""
    directory = tmp_path_factory.mktemp("cli_base")
    train.main([*SMALL, "--steps", "2", "--ckpt-dir", str(directory)])
    return str(directory)


def rewrite(src, dst, meta=None, data_step=None):
    """A copy of ``src``'s step-2 envelope in ``dst`` with ``meta`` entries
    changed and the data cursor set (the crc recomputed)."""
    name = "ckpt_0000000002.msgpack"
    payload = msgpack.unpackb(open(os.path.join(src, name), "rb").read(), raw=False)
    payload["meta"].update(meta or {})
    if data_step is not None:
        leaf = next(d for d in payload["leaves"] if d["path"] == "['data_step']")
        leaf["data"] = np.int32(data_step).tobytes()
    crc = 0
    for d in payload["leaves"]:
        if d["kind"] == "array":
            crc = zlib.crc32(d["data"], crc)
    payload["crc32"] = crc
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(dst, name), "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    return dst


GUARDS = {
    "ckpt-every": (lambda src, dst: rewrite(src, dst), ["--ckpt-every", "2"],
                   "--ckpt-every requires --ckpt-dir"),
    "resume-dir": (lambda src, dst: rewrite(src, dst), ["--resume"],
                   "--resume requires --ckpt-dir"),
    "rank-schedule": (lambda src, dst: rewrite(src, dst),
                      ["--rank-schedule", "1@0,2@2"],
                      "--rank-schedule '1@0,2@2' does not match the "
                      "checkpoint's None — resume with the schedule the run "
                      "was started with"),
    "staleness": (lambda src, dst: rewrite(src, dst, {"staleness": "one_step"}),
                  [], "--staleness 'none' does not match the checkpoint's "
                      "'one_step'"),
    "wire-dtype": (lambda src, dst: rewrite(src, dst), ["--wire-dtype", "int4"],
                   "--wire-dtype 'int4' does not match the checkpoint's 'auto'"),
    "data-cursor": (lambda src, dst: rewrite(src, dst, data_step=1), [],
                    "checkpoint data cursor 1 does not match its step counter 2"),
}


@pytest.mark.parametrize("guard", list(GUARDS))
def test_resume_guard_refuses(envelope, tmp_path, capsys, guard):
    make, argv, text = GUARDS[guard]
    dst = make(envelope, str(tmp_path / "ck"))
    resume = [] if guard in ("ckpt-every", "resume-dir") else [
        "--resume", "--ckpt-dir", dst]
    with pytest.raises(SystemExit) as exc:
        train.main([*SMALL, "--steps", "4", *resume, *argv])
    said = str(exc.value) + capsys.readouterr().err
    assert text in said, said
    assert not tdist.is_initialized()


@pytest.mark.parametrize("argv,item", [
    (["--staleness", "one_step"], "item 12"),
    (["--sync-mode", "broadcast"], "item 13"),
    (["--arch", "mamba2_1p3b"], "item 15")], ids=["item 12", "item 13", "item 15"])
def test_unported_options_raise(capsys, argv, item):
    """Item 15's training half is ported: one step of reduced Mamba2-1.3B
    trains (at S = 32, a multiple of its SSD chunk) and ``main`` returns;
    item 12, one-step staleness, is ported: one step trains and ``main``
    returns.  Item 13,
    ``sync_mode="broadcast"``, is ported: two steps train and end on the
    plain run's ``hex=`` (at one rank the canonical reduce of one row is
    that row, divided by 1, and the broadcast delivers it unchanged)."""
    if item == "item 12":
        out = cli(capsys, "--steps", "1", *argv)
        assert "step    0 loss=" in out and final_hex(out)
        return
    if item == "item 13":
        out = cli(capsys, "--steps", "2", *argv)
        assert "step    0 loss=" in out
        assert final_hex(out) == final_hex(cli(capsys, "--steps", "2"))
        return
    out = cli(capsys, "--steps", "1", "--seq", "33", *argv)
    assert "step    0 loss=" in out and final_hex(out)


def test_one_step_resume_ends_on_the_same_hex(tmp_path, capsys):
    stale = ["--staleness", "one_step"]
    straight = cli(capsys, "--steps", "6", "--ckpt-dir", str(tmp_path / "a"), *stale)
    cli(capsys, "--steps", "3", "--ckpt-dir", str(tmp_path / "b"), *stale)
    payload = msgpack.unpackb(open(tmp_path / "b" / "ckpt_0000000003.msgpack",
                                   "rb").read(), raw=False)
    assert payload["meta"]["staleness"] == "one_step"
    parked = [np.frombuffer(d["data"], "<f4") for d in payload["leaves"]
              if d["path"].startswith("['ef'].inflight")]
    assert len(parked) > 1 and any(np.abs(x).max() > 0 for x in parked)
    tail = cli(capsys, "--steps", "6", "--ckpt-dir", str(tmp_path / "b"),
               "--resume", *stale)
    assert "resumed from step 3" in tail
    assert final_hex(tail) == final_hex(straight)


REFERENCE_RUNS = {"none": [], "one_step": ["--staleness", "one_step"]}


@pytest.fixture(scope="module")
def reference_clis(tmp_path_factory):
    """The JAX package's CLI in processes of its own on one CPU device,
    synchronous and one-step at once: 6 steps each, an envelope at step 4
    and at step 6.  {mode: (directory, standard output)}."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for mode, extra in REFERENCE_RUNS.items():
        directory = str(tmp_path_factory.mktemp(f"ref_cli_{mode}"))
        procs[mode] = (directory, subprocess.Popen(
            [sys.executable, "-m", "repro.launch.train", "--steps", "6",
             "--batch", "4", "--seq", "32", "--ckpt-dir", directory,
             "--ckpt-every", "4", *extra], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    try:
        for mode, (directory, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, stdout + stderr
            out[mode] = (directory, stdout)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.fixture(scope="module")
def reference_cli(reference_clis):
    return reference_clis["none"]


def params_of(path):
    payload = msgpack.unpackb(open(path, "rb").read(), raw=False)
    return {d["path"]: np.frombuffer(d["data"], d["dtype"]).reshape(d["shape"])
            for d in payload["leaves"] if d["path"].startswith("['params']")}


def test_reference_cli_envelope_resumes_in_the_port_cli(reference_cli, tmp_path,
                                                       capsys):
    directory, out = reference_cli
    mine = tmp_path / "port"
    mine.mkdir()
    shutil.copy(os.path.join(directory, "ckpt_0000000004.msgpack"), mine)
    tail = cli(capsys, "--steps", "6", "--ckpt-dir", str(mine), "--resume")
    assert "resumed from step 4" in tail
    np.testing.assert_allclose(float.fromhex(final_hex(tail)),
                               float.fromhex(final_hex(out)), rtol=1e-5)
    want = params_of(os.path.join(directory, "ckpt_0000000006.msgpack"))
    got = params_of(str(mine / "ckpt_0000000006.msgpack"))
    assert list(got) == list(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=2e-6, rtol=0,
                                   err_msg=path)


def test_reference_one_step_cli_envelope_resumes_in_the_port_cli(
        reference_clis, tmp_path, capsys):
    """The JAX package's ``--staleness one_step`` envelope at step 4, its
    in-flight aggregate included, resumed by the port's CLI to step 6:
    loss and parameters within the tolerances above."""
    directory, out = reference_clis["one_step"]
    mine = tmp_path / "port"
    mine.mkdir()
    shutil.copy(os.path.join(directory, "ckpt_0000000004.msgpack"), mine)
    tail = cli(capsys, "--steps", "6", "--ckpt-dir", str(mine), "--resume",
               "--staleness", "one_step")
    assert "resumed from step 4" in tail
    np.testing.assert_allclose(float.fromhex(final_hex(tail)),
                               float.fromhex(final_hex(out)), rtol=1e-5)
    want = params_of(os.path.join(directory, "ckpt_0000000006.msgpack"))
    got = params_of(str(mine / "ckpt_0000000006.msgpack"))
    assert list(got) == list(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=2e-6, rtol=0,
                                   err_msg=path)
