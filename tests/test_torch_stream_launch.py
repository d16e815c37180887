"""The port's launch layer for streaming (CPU): ``launch.train --arch svm_bsgd
--stream`` and ``launch.serve --live``, streaming checkpoints across the two
packages, and the port's import boundary.

  * ``python -m repro_torch.launch.train --arch svm_bsgd --stream DIR|FILE
    --device cpu`` runs and writes the state a direct ``fit_stream`` /
    ``fit_multiclass_stream`` call computes, bit for bit;
  * ``serve --live`` runs with and without ``--faults`` at the reference's
    smoke sizes, and its supervisor restarts a crashed trainer;
  * a port streaming checkpoint serves through the reference's
    ``load_serve_model``, and a reference one through the port's;
  * a child process imports every ``repro_torch`` module, after which
    neither ``jax`` nor ``repro`` is in ``sys.modules``;
  * the kernels' launch counters under threads and graph captures, and
    ``cuda_graph=True``, which leaves a CPU stream as it is.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

import repro.core as jcore
import repro.data as jdata
from repro_torch import checkpoint as tckpt
from repro_torch import core as tcore
from repro_torch import data as tdata

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = "cpu"


def _cli(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", f"repro_torch.launch.{module}", *args],
                          capture_output=True, text=True, timeout=timeout, env=env)


def _bit_equal(a, b):
    for name, u, v in zip(a._fields, a, b):
        if u is None:
            assert v is None, name
            continue
        assert u.dtype == v.dtype and torch.equal(u, v), name


def _restored(ck, like):
    step = tckpt.latest_step(ck)
    return tckpt.load(ck, step, {"state": like}, device=CPU)["state"]


def test_train_cli_streams_npz_shards_as_fit_stream(tmp_path):
    x, y = tdata.make_blobs(np.random.default_rng(0), 256, 8)
    shards = str(tmp_path / "shards")
    tdata.write_npz_chunks(shards, x, y, 64)
    ck = str(tmp_path / "ck")
    out = _cli("train", "--arch", "svm_bsgd", "--stream", shards, "--svm-budget", "16",
               "--batch-size", "8", "--seed", "2", "--ckpt-dir", ck, "--ckpt-every", "4",
               "--prefetch", "2", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "svm stream done on cpu: layout=replicated chunks=4 rows=256" in out.stdout
    cfg = tcore.BSGDConfig(budget=16, lambda_=1e-4, gamma=0.5, batch_size=8)
    direct = tcore.fit_stream(cfg, tdata.FileChunks(sorted(
        os.path.join(shards, f) for f in os.listdir(shards))), seed=2, device=CPU)
    assert tckpt.load_metadata(ck, 4)["next_chunk"] == 4
    _bit_equal(direct, _restored(ck, direct))


def test_train_cli_streams_a_libsvm_file_on_the_class_axis(tmp_path):
    x, y = tdata.make_blobs_multiclass(np.random.default_rng(1), 192, 8, 4, sep=2.0)
    path = str(tmp_path / "d.libsvm")
    tdata.dump_libsvm(path, x, y)
    ck = str(tmp_path / "ck")
    out = _cli("train", "--arch", "svm_bsgd", "--stream", path, "--svm-layout", "class",
               "--svm-classes", "4", "--svm-budget", "12", "--chunk-rows", "48",
               "--n-features", "8", "--ckpt-dir", ck, "--ckpt-every", "4", "--retry", "3",
               "--guard-finite", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "resilience: ResilienceReport(retries=0" in out.stdout
    cfg = tcore.MulticlassSVMConfig.create(4, budget=12, lambda_=1e-4, gamma=0.5, batch_size=8)
    direct = tcore.fit_multiclass_stream(cfg, tdata.LibsvmChunks(path, 48, 8, binary=False),
                                         device=CPU)
    assert bool((direct.count > 0).all())
    _bit_equal(direct, _restored(ck, direct))


@pytest.mark.parametrize("argv", [["--arch", "smollm_360m", "--smoke"]])
def test_train_cli_lm_arm_trains(argv, tmp_path, capsys):
    """The language-model arm beside the SVM arm: it ignores ``--stream``'s
    options and trains (its own tests: ``test_torch_lm_train.py``)."""
    from repro_torch.launch import train
    train.main(argv + ["--steps", "2", "--batch-size", "2", "--seq-len", "8", "--ckpt-dir",
                       str(tmp_path / "ck"), "--device", "cpu"])
    assert "[train] done: smollm_360m final loss" in capsys.readouterr().out
    assert tckpt.latest_step(str(tmp_path / "ck")) == 2


def test_train_cli_slots_layout_on_one_process_is_fit_stream(tmp_path, capsys):
    """``--svm-layout slots`` outside ``torchrun`` is the single-device
    ``fit_stream`` (its distributed runs: ``test_torch_distributed.py``)."""
    from repro_torch.launch import train
    x, y = tdata.make_blobs(np.random.default_rng(0), 32, 4)
    tdata.write_npz_chunks(str(tmp_path / "s"), x, y, 16)
    ck = str(tmp_path / "ck")
    train.main(["--arch", "svm_bsgd", "--stream", str(tmp_path / "s"), "--svm-layout", "slots",
                "--svm-budget", "4", "--ckpt-dir", ck, "--ckpt-every", "2", "--device", "cpu"])
    assert "layout=slots chunks=2 rows=32" in capsys.readouterr().out
    cfg = tcore.BSGDConfig(budget=4, lambda_=1e-4, gamma=0.5, batch_size=8)
    direct = tcore.fit_stream(cfg, tdata.FileChunks(sorted(
        str(p) for p in (tmp_path / "s").iterdir())), device=CPU)
    _bit_equal(direct, _restored(ck, direct))


def test_train_cli_needs_a_stream():
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="--stream"):
        train.main(["--arch", "svm_bsgd", "--device", "cpu"])


@pytest.mark.parametrize("faults", [False, True], ids=["clean", "chaos"])
def test_serve_cli_live_runs_on_the_cpu(faults):
    args = ["--arch", "svm_bsgd", "--smoke", "--live", "--device", "cpu"]
    out = _cli("serve", *args, *(["--faults", "0"] if faults else []))
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert "versions served" in out.stdout and "rows/s" in out.stdout
    assert "final snapshot queue == direct predict (bitwise)" in out.stdout
    if faults:
        assert "resilience:" in out.stdout and "final snapshot finite" in out.stdout
        assert "trainer crashed" in out.stdout


def test_live_supervisor_restarts_a_crashed_trainer(watchdog):
    """A crash-once chunk kills the trainer mid-run: serving stays up on the
    last published version, the supervisor restarts the trainer from the
    newest verifiable checkpoint, a fatal shard quarantines, and the run
    ends with a finite final snapshot, as the reference's drill."""
    watchdog(600)
    from repro_torch.launch.serve import serve_svm_live
    faults = tdata.FaultSchedule(seed=0, io_chunks=(1,), io_attempts=1, crash_chunks=(5,),
                                 fatal_chunks=(6,))
    result = serve_svm_live(train_rows=1024, chunk_rows=128, epochs=2, publish_every=2,
                            budget=16, rows=512, max_batch=64, verbose=False, faults=faults,
                            max_restarts=2, device=CPU)
    assert result["restarts"] >= 1
    assert 6 in result["quarantined"]
    assert result["retries"] >= 1
    assert result["final_version"] >= 2
    assert result["rows"] == 512 and result["final_check_rows"] == 512


def test_port_streaming_checkpoint_serves_in_the_reference(tmp_path):
    x, y = tdata.make_blobs_multiclass(np.random.default_rng(3), 240, 6, 3, sep=2.0)
    cfg = tcore.MulticlassSVMConfig.create(3, budget=12, lambda_=1e-3, gamma=0.5, batch_size=8,
                                           use_kernel_cache=True)
    ck = str(tmp_path / "ck")
    st = tcore.fit_multiclass_stream(cfg, tdata.ArrayChunks(x, y, 60), seed=1, ckpt_dir=ck,
                                     ckpt_every=2, device=CPU)
    meta = tckpt.load_metadata(ck, 4)
    assert meta["kind"] == "stream-epoch" and meta["shuffle"] == "numpy"
    jm = jcore.load_serve_model(ck, 0.5)
    tm = tcore.load_serve_model(ck, 0.5, device=CPU)
    want = tcore.export_model(st, 0.5)
    np.testing.assert_array_equal(np.asarray(jm.sv_x), want.sv_x.numpy())
    np.testing.assert_array_equal(np.asarray(jm.alpha), want.alpha.numpy())
    assert torch.equal(tm.sv_x, want.sv_x) and torch.equal(tm.alpha, want.alpha)
    rows = np.random.default_rng(4).standard_normal((50, 6)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jcore.predict_labels(jm, rows, impl="ref")),
                                  tcore.predict_labels(tm, rows).numpy())


def test_reference_streaming_checkpoint_serves_in_the_port(tmp_path):
    x, y = tdata.make_blobs(np.random.default_rng(5), 200, 6)
    cfg = jcore.BSGDConfig(budget=12, lambda_=1e-3, gamma=0.5, batch_size=4)
    ck = str(tmp_path / "ck")
    st = jcore.fit_stream(cfg, jdata.ArrayChunks(x, y, 50), seed=1, ckpt_dir=ck, ckpt_every=2,
                          impl="ref")
    tm = tcore.load_serve_model(ck, 0.5, device=CPU)
    np.testing.assert_array_equal(tm.sv_x[0].numpy(), np.asarray(st.sv_x))
    assert tm.binary and int(tm.count[0]) == int(st.count)
    rows = np.random.default_rng(6).standard_normal((40, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tcore.predict_labels(tm, rows).numpy(),
        np.asarray(jcore.predict_labels(jcore.export_model(st, 0.5), rows, impl="ref")))


def test_the_port_imports_neither_jax_nor_repro():
    code = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) > 30, names
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("imported", len(names))
"""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


def test_launch_counters_lose_no_count_across_threads():
    """A trainer and a server launch at once: every count lands."""
    import threading

    from repro_torch.kernels import _build
    scope = {"launches": 0}

    def work():
        for _ in range(20_000):
            _build.count(scope, "launches")

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert scope["launches"] == 80_000


def test_a_capture_tally_counts_at_each_replay_and_not_before():
    """Inside ``recording()`` this thread's launches enter the tally, not the
    counter (a capture launches nothing); another thread's still count;
    ``add_counts`` counts the tally once a replay."""
    import threading

    from repro_torch.kernels import _build
    a, b = {"launches": 0}, {"pick_launches": 0}
    with _build.recording() as tally:
        for _ in range(3):
            _build.count(a, "launches")
        _build.count(b, "pick_launches")
        other = threading.Thread(target=lambda: _build.count(a, "launches"))
        other.start()
        other.join()
    assert a == {"launches": 1} and b == {"pick_launches": 0}
    for _ in range(2):
        _build.add_counts(tally)
    assert a == {"launches": 7} and b == {"pick_launches": 2}
    _build.count(a, "launches")                    # the tally is closed
    assert a == {"launches": 8} and len(tally) == 2


@pytest.mark.parametrize("engine", [dict(), dict(step_engine="pallas")], ids=["composed", "fused"])
def test_cuda_graph_on_the_cpu_is_the_eager_stream(engine):
    """``cuda_graph=True`` changes nothing on the CPU: the chunk programs run
    as they are, bit for bit."""
    x, y = tdata.make_blobs_multiclass(np.random.default_rng(3), 300, 6, 3)
    cfg = tcore.MulticlassSVMConfig.create(3, budget=10, lambda_=1e-3, gamma=0.5, batch_size=8,
                                           use_kernel_cache=True, **engine)
    src = tdata.ArrayChunks(x, y, 70)
    runs = [tcore.fit_multiclass_stream(cfg, src, seed=2, prefetch=1, cuda_graph=g, device=CPU)
            for g in (False, True)]
    for u, v in zip(*runs):
        assert u is None and v is None or torch.equal(u, v)
    bx, by = tdata.make_blobs(np.random.default_rng(4), 200, 6)
    bcfg = tcore.BSGDConfig(budget=10, lambda_=1e-3, gamma=0.5, batch_size=4,
                            use_kernel_cache=True, **engine)
    runs = [tcore.fit_stream(bcfg, tdata.ArrayChunks(bx, by, 50), seed=1, cuda_graph=g,
                             device=CPU) for g in (False, True)]
    for u, v in zip(*runs):
        assert u is None and v is None or torch.equal(u, v)


def test_live_problem_is_the_arms_trainer_config():
    from repro_torch.launch import serve
    cfg, src = serve.live_problem(n_classes=3, budget=20, dim=5, train_rows=300, chunk_rows=40)
    assert cfg.n_classes == 3 and cfg.binary.budget == 20 and cfg.binary.batch_size == 40
    assert not cfg.binary.use_kernel_cache and src.n_chunks == 8 and src.dim == 5
    x, y = src.load(0)
    assert x.shape == (40, 5) and y.min() >= 0 and y.max() < 3
