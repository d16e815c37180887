"""The port's checkpoints: the reference's on-disk format, both ways (CPU).

  * a ``{"state": SVMState}`` the JAX package wrote (with and without the
    kernel cache, fp32 and bf16 bank) serves in the port bit-equal to the
    port's ``export_model`` of the same state;
  * a port-written checkpoint has the reference's manifest (keys, dtypes,
    crc32s) and the same array bytes; an fp32 one serves in the reference.
    A bf16 one is byte-identical to the reference's own, which the
    reference itself cannot restore (numpy stores bf16 as raw ``|V2``
    records, which its ``astype`` and ``verify_step`` refuse);
  * ``tests/core/test_checkpoint_failures.py``'s format cases in the port:
    a missing or corrupt manifest, truncated or missing arrays, missing
    leaves, a crc mismatch, ``verify_step`` and ``restore_latest`` walking
    back past a torn step, and the atomic save under a simulated crash.
"""
import json
import os
import subprocess
import sys
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro import checkpoint as jckpt
from repro.core import bsgd as jbsgd
from repro.core import load_serve_model as jload_serve_model
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.checkpoint import checkpointer as cp
from repro_torch.core import SVMState, export_model, load_serve_model, predict_labels

CPU = "cpu"
GAMMA = 0.5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _leaves(seed, *, c=3, slots=12, dim=5, binary=False, kmat=False):
    rng = np.random.default_rng(seed)
    lead = () if binary else (c,)
    out = dict(sv_x=rng.standard_normal(lead + (slots, dim)).astype(np.float32),
               alpha=rng.standard_normal(lead + (slots,)).astype(np.float32),
               count=rng.integers(1, slots + 1, lead).astype(np.int32),
               step=np.full(lead, 7, np.int32), n_inserts=np.full(lead, 11, np.int32),
               n_merges=np.full(lead, 3, np.int32))
    if kmat:
        out["kmat"] = rng.random(lead + (slots, slots)).astype(np.float32)
    return out


def _jax_state(leaves, bf16):
    js = jbsgd.SVMState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return js._replace(sv_x=js.sv_x.astype(jnp.bfloat16)) if bf16 else js


def _port_state(leaves, bf16):
    ts = convert.state_from_numpy(leaves, device=CPU)
    return ts._replace(sv_x=ts.sv_x.to(torch.bfloat16)) if bf16 else ts


def _manifest(d, step=1):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _arrays(d, step=1):
    with np.load(os.path.join(d, f"step_{step:08d}", "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


CASES = [(b, k, bf) for b in (False, True) for k in (False, True) for bf in (False, True)]
IDS = [f"{'binary' if b else 'multiclass'}-{'kmat' if k else 'nocache'}-{'bf16' if bf else 'fp32'}"
       for b, k, bf in CASES]


@pytest.mark.parametrize("binary,kmat,bf16", CASES, ids=IDS)
def test_jax_written_checkpoint_serves_in_the_port(tmp_path, binary, kmat, bf16):
    leaves = _leaves(1, binary=binary, kmat=kmat)
    d = str(tmp_path / "ck")
    jckpt.save(d, 4, {"state": _jax_state(leaves, bf16), "cursor": jnp.int32(2)})
    got = load_serve_model(d, GAMMA, device=CPU)
    want = export_model(_port_state(leaves, bf16), GAMMA)
    assert got.binary is binary and got.sv_x.dtype == want.sv_x.dtype
    for name in ("sv_x", "alpha", "count"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    x = np.random.default_rng(2).standard_normal((20, 5)).astype(np.float32)
    assert torch.equal(predict_labels(got, x), predict_labels(want, x))


@pytest.mark.parametrize("binary,kmat,bf16", CASES, ids=IDS)
def test_port_written_checkpoint_matches_the_reference_format(tmp_path, binary, kmat, bf16):
    leaves = _leaves(3, binary=binary, kmat=kmat)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(dj, 1, {"state": _jax_state(leaves, bf16)}, metadata={"epoch": 0})
    ckpt.save(dt, 1, {"state": _port_state(leaves, bf16)}, metadata={"epoch": 0})
    assert _manifest(dt) == _manifest(dj)
    assert list(_manifest(dt)["leaves"]) == list(_manifest(dj)["leaves"])
    aj, at = _arrays(dj), _arrays(dt)
    assert list(at) == list(aj)
    for k in aj:
        assert at[k].dtype == aj[k].dtype and at[k].tobytes() == aj[k].tobytes(), k
    if bf16:
        # the reference refuses its own bf16 checkpoints the same way
        for d in (dj, dt):
            with pytest.raises(ValueError, match="dtype"):
                jckpt.verify_step(d, 1)
        ckpt.verify_step(dt, 1)
        return
    jckpt.verify_step(dt, 1)
    jm = jload_serve_model(dt, GAMMA)
    tm = load_serve_model(dt, GAMMA, device=CPU)
    np.testing.assert_array_equal(np.asarray(jm.sv_x), tm.sv_x.numpy())
    np.testing.assert_array_equal(np.asarray(jm.alpha), tm.alpha.numpy())
    np.testing.assert_array_equal(np.asarray(jm.count), tm.count.numpy())


class _Pair(NamedTuple):
    a: object
    b: object = None


def test_leaf_keys_follow_the_reference_flatten(tmp_path):
    """dict keys (sorted), list and tuple indices, NamedTuple field names; a
    None leaf is left out."""
    tree = {"z": [np.arange(3, dtype=np.int32), (np.float32(2.5), None)],
            "a": _Pair(a=np.ones((2, 2), np.float32)), "m": {"y": np.int64(4), "x": None}}
    jtree = {"z": [jnp.arange(3, dtype=jnp.int32), (jnp.float32(2.5), None)],
             "a": _Pair(a=jnp.ones((2, 2), jnp.float32)), "m": {"y": np.int64(4), "x": None}}
    ckpt.save(str(tmp_path / "t"), 1, tree)
    jckpt.save(str(tmp_path / "j"), 1, jtree)
    keys = list(_manifest(str(tmp_path / "t"))["leaves"])
    assert keys == list(_manifest(str(tmp_path / "j"))["leaves"])
    assert keys == ["a/a", "m/y", "z/0", "z/1/0"]
    back = ckpt.load(str(tmp_path / "j"), 1, {
        "z": [ckpt.ShapeDtype((3,), torch.int32), (ckpt.ShapeDtype((), torch.float32), None)],
        "a": _Pair(a=torch.zeros(2, 2)), "m": {"y": ckpt.ShapeDtype((), torch.int64), "x": None}},
        device=CPU)
    assert isinstance(back["a"], _Pair) and back["a"].b is None and back["m"]["x"] is None
    assert back["z"][0].dtype == torch.int32 and float(back["z"][1][0]) == 2.5
    assert torch.equal(back["a"].a, torch.ones(2, 2))


def test_load_casts_to_the_target_and_places_on_the_device(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 2, {"w": torch.arange(6.0).reshape(2, 3)})
    got = ckpt.load(d, 2, {"w": ckpt.ShapeDtype((2, 3), torch.bfloat16)}, device=CPU)["w"]
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    assert torch.equal(got.float(), torch.arange(6.0).reshape(2, 3))
    with pytest.raises(ValueError, match="shape"):
        ckpt.load(d, 2, {"w": torch.zeros(3, 2)}, device=CPU)


def test_load_serve_model_rejects_non_svm_and_empty(tmp_path):
    d = str(tmp_path / "lm")
    ckpt.save(d, 1, {"params": {"w": torch.ones(2, 2)}})
    with pytest.raises(ValueError, match="not an SVM training checkpoint"):
        load_serve_model(d, GAMMA, device=CPU)
    with pytest.raises(ValueError, match="no complete checkpoint"):
        load_serve_model(str(tmp_path / "empty"), GAMMA, device=CPU)
    ckpt.save(d, 2, {"state": torch.zeros(2)})
    with open(os.path.join(d, "step_00000002", "manifest.json"), "w") as f:
        f.write('{"leaves": {"trunc')
    with pytest.raises(ValueError, match="corrupt"):
        load_serve_model(d, GAMMA, device=CPU)


def test_load_serve_model_serves_the_latest_step_unless_told(tmp_path):
    d = str(tmp_path / "ck")
    early, late = _leaves(5), _leaves(6)
    ckpt.save(d, 1, {"state": _port_state(early, False)})
    ckpt.save(d, 2, {"state": _port_state(late, False)})
    assert torch.equal(load_serve_model(d, GAMMA, device=CPU).alpha,
                       export_model(_port_state(late, False), GAMMA).alpha)
    assert torch.equal(load_serve_model(d, GAMMA, step=1, device=CPU).alpha,
                       export_model(_port_state(early, False), GAMMA).alpha)


# ---- format failures (tests/core/test_checkpoint_failures.py) ----------------


def _saved(tmp_path, step=3):
    d = str(tmp_path / "ck")
    ckpt.save(d, step, {"w": torch.arange(6.0).reshape(2, 3)},
              metadata={"kind": "test", "cursor": 7})
    return d


W = {"w": ckpt.ShapeDtype((2, 3), torch.float32)}


def test_load_metadata_roundtrip_and_failures(tmp_path):
    d = _saved(tmp_path)
    assert ckpt.load_metadata(d, 3) == {"kind": "test", "cursor": 7}
    with pytest.raises(ValueError, match="no manifest"):
        ckpt.load_metadata(d, 99)
    path = os.path.join(d, "step_00000003", "manifest.json")
    with open(path, "w") as f:
        f.write('{"metadata": {"trunc')
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.load_metadata(d, 3)
    os.remove(path)
    with pytest.raises(ValueError, match="no manifest"):
        ckpt.load_metadata(d, 3)


def test_load_truncated_or_missing_arrays(tmp_path):
    d = _saved(tmp_path)
    path = os.path.join(d, "step_00000003", "arrays.npz")
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(ValueError, match="truncated or corrupt"):
        ckpt.load(d, 3, W, device=CPU)
    os.remove(path)
    with pytest.raises(ValueError, match="no arrays.npz"):
        ckpt.load(d, 3, W, device=CPU)


def test_load_missing_leaves_is_valueerror(tmp_path):
    d = _saved(tmp_path)
    with pytest.raises(ValueError, match="missing leaves"):
        ckpt.load(d, 3, {**W, "extra": ckpt.ShapeDtype((), torch.float32)}, device=CPU)


def test_crc_detects_silently_modified_leaf(tmp_path):
    d = _saved(tmp_path)
    step_dir = os.path.join(d, "step_00000003")
    arrs = _arrays(d, 3)
    arrs["w"] = arrs["w"].copy()
    arrs["w"].flat[0] += 1.0                      # same shape, same dtype
    np.savez(os.path.join(step_dir, "arrays.npz"), **arrs)
    with pytest.raises(ValueError, match="checksum"):
        ckpt.load(d, 3, W, device=CPU)
    with pytest.raises(ValueError, match="checksum"):
        ckpt.verify_step(d, 3)


def test_verify_step_passes_clean_and_names_torn_files(tmp_path):
    d = _saved(tmp_path)
    ckpt.verify_step(d, 3)
    step_dir = os.path.join(d, "step_00000003")
    os.remove(os.path.join(step_dir, "arrays.npz"))
    with pytest.raises(ValueError, match="torn write"):
        ckpt.verify_step(d, 3)
    os.remove(os.path.join(step_dir, "manifest.json"))
    with pytest.raises(ValueError, match="torn write"):
        ckpt.verify_step(d, 3)


def test_restore_latest_walks_back_past_torn_step(tmp_path):
    d = str(tmp_path / "ck")
    for step in (1, 2, 3):
        ckpt.save(d, step, {"w": torch.full((2, 3), float(step))})
    os.remove(os.path.join(d, "step_00000003", "arrays.npz"))     # torn
    assert ckpt.latest_step(d) == 3 and ckpt.latest_verifiable_step(d) == 2
    step, tree = ckpt.restore_latest(d, W, device=CPU)
    assert step == 2 and torch.equal(tree["w"], torch.full((2, 3), 2.0))


def test_restore_latest_refuses_when_nothing_verifies(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": torch.zeros(2, 3)})
    os.remove(os.path.join(d, "step_00000001", "manifest.json"))
    with pytest.raises(ValueError, match="none verify"):
        ckpt.restore_latest(d, W, device=CPU)
    assert ckpt.restore_latest(str(tmp_path / "empty"), W, device=CPU) == (None, None)


def test_keep_last_and_async_snapshot(tmp_path):
    d = str(tmp_path / "ck")
    w = torch.zeros(2, 3)
    for step in range(1, 6):
        w.fill_(float(step))
        ckpt.save(d, step, {"w": w}, keep_last=2)
    assert ckpt.all_steps(d) == [4, 5]
    w.fill_(6.0)
    t = ckpt.save_async(d, 6, {"w": w, "s": SVMState(*(torch.ones(1),) * 6)}, keep_last=0)
    w.fill_(-1.0)                                 # training goes on in place
    t.join(30.0)
    assert ckpt.all_steps(d) == [4, 5, 6]
    assert torch.equal(ckpt.load(d, 6, W, device=CPU)["w"], torch.full((2, 3), 6.0))
    assert "s/kmat" not in _manifest(d, 6)["leaves"] and "s/n_merges" in _manifest(d, 6)["leaves"]


def test_save_is_atomic_under_simulated_crash(tmp_path, monkeypatch):
    """Kill the writer at every fsync point: the step directory either does
    not exist or verifies completely."""
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(6.0).reshape(2, 3)}

    class _Crash(RuntimeError):
        pass

    real_fsync = os.fsync
    for crash_at in (1, 2, 3):
        calls = {"n": 0}

        def fsync(fd, _crash_at=crash_at, _calls=calls):
            _calls["n"] += 1
            if _calls["n"] == _crash_at:
                raise _Crash(f"crash at fsync #{_crash_at}")
            return real_fsync(fd)

        monkeypatch.setattr(cp.os, "fsync", fsync)
        with pytest.raises(_Crash):
            cp.save(d, 7, tree)
        monkeypatch.setattr(cp.os, "fsync", real_fsync)
        assert ckpt.all_steps(d) == []
        assert not os.path.exists(os.path.join(d, "step_00000007"))
    cp.save(d, 7, tree)
    ckpt.verify_step(d, 7)


# ---- the entry point on a checkpoint the reference wrote ---------------------


def test_serve_cli_serves_a_jax_written_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    jckpt.save(d, 9, {"state": _jax_state(_leaves(8, c=3, slots=16, dim=6, kmat=True), True)})
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", "svm_bsgd",
                          "--model", d, "--gamma", "0.5", "--rows", "300", "--max-batch", "64",
                          "--top-k", "2", "--device", "cpu"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert f"loaded {d}: C=3 slots=16 dim=6 bank=torch.bfloat16" in out.stdout
    assert "queue == direct predict (bitwise)" in out.stdout
