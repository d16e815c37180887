"""The language-model trainer's process-level contract on the CPU: the
``FAULT_AT_STEP`` crash in a child, ``launch.elastic``'s restart after it,
two data-parallel ranks under ``torchrun`` against one process, and the
supervisor's limits.  Each child runs one intra-op thread (the suite's
workers share the machine's cores); the in-process trainer's tests are in
``test_torch_lm_train.py``.
"""
import os
import subprocess
import sys

import pytest
from helpers.torch_lm import one_thread  # noqa: F401 (autouse fixture)

from repro_torch import checkpoint as tckpt
from repro_torch.configs import get_smoke
from repro_torch.launch import elastic, train
from repro_torch.launch.elastic import supervise

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def _cli(*argv, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), **ONE_THREAD)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *argv], capture_output=True, text=True, env=env,
                          timeout=300)


def test_fault_injection_exits_137_in_a_child(tmp_path):
    ck = str(tmp_path / "ck")
    out = _cli("-m", "repro_torch.launch.train", "--arch", "smollm_360m", "--smoke", "--steps",
               "6", "--ckpt-dir", ck, "--ckpt-every", "2", "--batch-size", "2", "--seq-len",
               "16", "--device", "cpu", env_extra={"FAULT_AT_STEP": "3"})
    assert out.returncode == 137, out.stderr
    assert "FAULT INJECTION at step 3" in out.stdout
    assert tckpt.all_steps(ck) == [2]


def test_elastic_restart_with_fault_injection(tmp_path, capsys, monkeypatch):
    """The child crashes at step 12; the supervisor restarts it, and it
    resumes from its step-8 checkpoint and completes."""
    for k, v in ONE_THREAD.items():
        monkeypatch.setenv(k, v)
    ck = str(tmp_path / "ck")
    restarts = elastic.main(["--arch", "smollm_360m", "--steps", "24", "--ckpt-dir", ck,
                             "--ckpt-every", "8", "--fault-at", "12", "--batch-size", "2",
                             "--seq-len", "32", "--device", "cpu"])
    assert restarts == 1
    assert "[elastic] done: restarts 1" in capsys.readouterr().out
    assert tckpt.latest_step(ck) == 24


def test_train_cli_data_parallel_under_torchrun(tmp_path):
    """Two gloo ranks (``torchrun``) train the batch split 4/4: rank 0 alone
    writes the checkpoints, and the loss is one process's on the whole batch."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", "smollm_360m", "--smoke", "--steps", "3", "--batch-size", "8",
            "--seq-len", "16", "--ckpt-dir", ck, "--device", "cpu"]
    out = _cli("-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
               "-m", "repro_torch.launch.train", *argv)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[train] done:") == 1 and "ranks=2" in out.stdout
    assert tckpt.all_steps(ck) == [3]
    got = float(out.stdout.split("final loss ")[1].split()[0])
    want = train.train_loop(get_smoke("smollm_360m"), steps=3, batch_size=8, seq_len=16,
                            verbose=False, device="cpu")["final_loss"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_elastic_restarts_under_torchrun_with_devices():
    """``--devices N`` runs the trainer's command under ``torchrun``."""
    import argparse

    ns = argparse.Namespace(arch="yi_9b", steps=5, ckpt_dir="ck", ckpt_every=2, batch_size=4,
                            seq_len=16, log_every=1, device="cpu", devices=2)
    cmd = elastic.child_command(ns)
    assert cmd[1:7] == ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                        "-m"]
    assert cmd[7:11] == ["repro_torch.launch.train", "--arch", "yi_9b", "--smoke"]
    assert cmd[-2:] == ["--device", "cpu"]
    ns.devices = None
    assert elastic.child_command(ns)[1:3] == ["-m", "repro_torch.launch.train"]


def test_supervise_gives_up_after_max_restarts():
    with pytest.raises(RuntimeError, match="kept failing"):
        supervise([sys.executable, "-c", "raise SystemExit(3)"], max_restarts=1, verbose=False)
