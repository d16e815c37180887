"""The port's distributed layer (``repro_torch.core.distributed``) on 2 gloo ranks (CPU).

One spawn of two CPU processes (``helpers.torch_dist_worker``, a gloo group
on a ``FileStore`` under ``tmp_path``, every collective under a timeout, the
join under a deadline) runs every case; each test reads its case's results.
Each layout's steps on 2 ranks are held against the port's single-process
step and the JAX reference's ``train_step``/``train_step_multiclass``
(``impl="ref"``) on the same numpy inputs through ``assert_state_parity``:
integers exact, floats within 1e-4 (the reference's own distributed tests'
tolerance).  The serve layout is bit-equal to one process's serve cell; the
chunk program, through ``launch.train.svm_stream_loop``, equals
``fit_stream``/``fit_multiclass_stream`` on the same ``EpochKey`` order.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from helpers import torch_dist_worker as W
from helpers.invariants import assert_state_parity

from repro.core import bsgd as jbsgd
from repro.core import multiclass as jmc
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch import data as tdata
from repro_torch.core.predict import serve_cell

WORLD = 2
JOIN_DEADLINE_S = 300.0
BASE = dict(budget=32, lambda_=1e-4, gamma=0.5, method="lookup-wd", batch_size=16)
CACHE = {**BASE, "use_kernel_cache": True}
STEP_CASES = [
    dict(name="replicated", layout="replicated", kw=BASE),
    dict(name="replicated-cache", layout="replicated", kw=CACHE),
    dict(name="replicated-bdca", layout="replicated", kw={**CACHE, "solver": "bdca"}),
    dict(name="replicated-fused", layout="replicated", kw={**CACHE, "step_engine": "pallas"}),
    dict(name="slots", layout="slots", kw=BASE),
    dict(name="slots-cache", layout="slots", kw=CACHE),
    dict(name="slots-gss", layout="slots", kw={**BASE, "method": "gss"}),
    dict(name="slots-fused", layout="slots", kw={**CACHE, "step_engine": "pallas"}),
    dict(name="slots-bdca", layout="slots", kw={**CACHE, "solver": "bdca"}),
    # 31 + 16 = 47 slots do not split over 2 ranks: the layout falls back
    dict(name="slots-fallback", layout="slots", kw={**BASE, "budget": 31}),
    dict(name="class", layout="class", classes=4, kw=BASE),
    dict(name="class-engine", layout="class", classes=4,
         kw={**CACHE, "maintenance_engine": "pallas"}),
    dict(name="class-fused", layout="class", classes=4, kw={**CACHE, "step_engine": "pallas"}),
    dict(name="class-multi-merge", layout="class", classes=4,
         kw={**CACHE, "maintenance": "multi-merge"}),
    dict(name="class-bdca", layout="class", classes=4, kw={**CACHE, "solver": "bdca"}),
    # 3 classes do not split over 2 ranks: every rank keeps every class
    dict(name="class-fallback", layout="class", classes=3, kw=BASE),
]
RAN = {"slots-fallback": "replicated", "class-fallback": "replicated"}
SERVE_CASES = [
    dict(name="serve-fp32", classes=4, kw=BASE),
    dict(name="serve-bf16", classes=4, kw=BASE, bank_dtype="bfloat16"),
    dict(name="serve-binary", kw=BASE),
]
LOOP = dict(budget=16, batch_size=8)
STREAM_CASES = [
    dict(name="stream-replicated", layout="replicated", chunk_rows=40, loop=LOOP),
    # killed after one chunk, then resumed from rank 0's checkpoint
    dict(name="stream-slots", layout="slots", chunk_rows=40, loop=LOOP, kill_after=1),
    dict(name="stream-class", layout="class", classes=4, chunk_rows=40, loop=LOOP),
]
CASES = ([{**c, "kind": "step"} for c in STEP_CASES] + [{**c, "kind": "serve"} for c in SERVE_CASES]
         + [{**c, "kind": "stream"} for c in STREAM_CASES] + [dict(name="errors", kind="error")])
ids = lambda cases: [c["name"] for c in cases]          # noqa: E731


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tiny single-process steps (the
    spawned ranks set their own): a busy machine's cores are shared."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Spawn the two ranks once for the module; ``{case: [rank 0, rank 1]}``."""
    out = tmp_path_factory.mktemp("dist")
    ctx = mp.start_processes(W.run, args=(WORLD, str(out / "store"), str(out), CASES),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_DEADLINE_S
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"distributed workers did not finish in {JOIN_DEADLINE_S} s")
    got = {c["name"]: [dict(np.load(out / f"{c['name']}-{r}.npz")) for r in range(WORLD)]
           for c in CASES}
    return got, out


def _ok(results, name):
    ranks = results[0][name]
    for r in ranks:
        assert "error" not in r, str(r["error"])
    return ranks


def _state(arrays, to=np.asarray):
    return jbsgd.SVMState(**{k: None if arrays.get(k) is None else to(arrays[k])
                             for k in jbsgd.SVMState._fields})


def _single(case):
    """The port's single-process steps from the same warm state."""
    cfg, _, step = W.single_step(case)
    st, x, y = W.warm_state(case)
    for i in range(W.STEPS):
        sl = slice(i * W.BATCH, (i + 1) * W.BATCH)
        st = step(cfg, cfg.table(), st, torch.as_tensor(x[sl]), W._labels(case, y[sl]))
    return st


def _reference(case):
    """The JAX reference's steps (``impl="ref"``) from the same warm state."""
    st, x, y = W.warm_state(case)
    st = _state(convert.state_to_numpy(st), jnp.asarray)
    if case.get("classes"):
        cfg = jmc.MulticlassSVMConfig.create(case["classes"], **case["kw"])
        step = jmc.train_step_multiclass
    else:
        cfg = jbsgd.BSGDConfig(**case["kw"])
        step = jbsgd.train_step
    table = cfg.table()
    for i in range(W.STEPS):
        sl = slice(i * W.BATCH, (i + 1) * W.BATCH)
        st = step(cfg, table, st, jnp.asarray(x[sl]), jnp.asarray(y[sl]), impl="ref")
    return st


@pytest.mark.parametrize("case", STEP_CASES, ids=ids(STEP_CASES))
def test_layout_steps_match_the_single_process_step(results, case):
    r0, r1 = _ok(results, case["name"])
    assert str(r0["layout"]) == RAN.get(case["name"], case["layout"])
    want = convert.state_to_numpy(_single(case))
    for name in want:                                           # every rank gathers one state
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
    want = _state(want)
    assert int(np.sum(want.n_merges)) > 0, "maintenance never fired"
    assert_state_parity(want, _state(r0), atol_float=1e-4, rtol=1e-5, context=case["name"])


@pytest.mark.parametrize("case", STEP_CASES, ids=ids(STEP_CASES))
def test_layout_steps_match_the_reference(results, case):
    """The reference's distributed contract: integer state exact, alpha within
    1e-4.  SV rows and the cache are held to the port's single-process step
    above: a merged z of the port may part from the reference's at a GSS
    mirror-mode tie (``slots-gss``: h against 1 - h, ROADMAP.md Queue 3) or
    by ~5e-4 under BDCA, in one process as on two ranks."""
    r0, _ = _ok(results, case["name"])
    want = _reference(case)
    for name in ("count", "step", "n_inserts", "n_merges"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)), r0[name], err_msg=name)
    np.testing.assert_allclose(r0["alpha"], np.asarray(want.alpha), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", [c for c in STEP_CASES if RAN.get(c["name"], c["layout"])
                                  == "replicated"], ids=lambda c: c["name"])
def test_replicated_ranks_hold_identical_states(results, case):
    """Every rank runs the same insert and maintenance on the same gathered
    inputs: each rank's own state hashes alike."""
    r0, r1 = _ok(results, case["name"])
    assert len(set(r0["digests"].tolist())) == 1
    np.testing.assert_array_equal(r0["digests"], r1["digests"])


@pytest.mark.parametrize("case", [c for c in STEP_CASES if c["layout"] != "replicated"
                                  and c["name"] not in RAN], ids=lambda c: c["name"])
def test_split_layouts_give_each_rank_its_own_part(results, case):
    r0, _ = _ok(results, case["name"])
    a, b = r0["digests"].tolist()
    assert a != b


@pytest.mark.parametrize("case", SERVE_CASES, ids=ids(SERVE_CASES))
def test_serve_layout_is_bit_equal_to_one_process(results, case):
    r0, r1 = _ok(results, case["name"])
    cfg = W.case_config(case)
    st, x, _ = W.warm_state(case)
    gamma = cfg.binary.gamma if case.get("classes") else cfg.gamma
    model = tcore.export_model(st, gamma, bank_dtype=case.get("bank_dtype"))
    scores, labels = serve_cell(model, torch.as_tensor(x))
    for r in (r0, r1):
        assert r["scores"].dtype == scores.numpy().dtype
        np.testing.assert_array_equal(r["scores"], scores.numpy())
        np.testing.assert_array_equal(r["labels"], labels.numpy())


def _stream_single(case):
    x, y = W.case_data(case)
    src = tdata.ArrayChunks(x, y, case["chunk_rows"])
    b = tcore.BSGDConfig(budget=case["loop"]["budget"], lambda_=1e-4, gamma=0.5,
                         batch_size=case["loop"]["batch_size"])
    if case.get("classes"):
        return tcore.fit_multiclass_stream(tcore.MulticlassSVMConfig(case["classes"], b), src,
                                           seed=3, device="cpu")
    return tcore.fit_stream(b, src, seed=3, device="cpu")


@pytest.mark.parametrize("case", STREAM_CASES, ids=ids(STREAM_CASES))
def test_chunk_program_matches_the_streaming_driver(results, case):
    """``svm_stream_loop`` over a group of 2 against ``fit_stream`` /
    ``fit_multiclass_stream`` in one process on the same ``EpochKey``; rank 0's
    last checkpoint holds the final state."""
    r0, r1 = _ok(results, case["name"])
    want = _stream_single(case)
    assert int(np.sum(want.n_merges.numpy())) > 0
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
    assert_state_parity(_state(convert.state_to_numpy(want)), _state(r0), atol_float=1e-4,
                        rtol=1e-5, context=case["name"])
    ck = str(results[1] / f"ck-{case['name']}")
    saved = tckpt.load(ck, tckpt.latest_step(ck), {"state": want}, device="cpu")["state"]
    for name, a in convert.state_to_numpy(saved).items():
        np.testing.assert_array_equal(a, r0[name], err_msg=name)


def test_a_batch_that_does_not_split_raises(results):
    """As the reference's pjit refuses a batch axis its mesh does not divide."""
    (r0, _) = _ok(results, "errors")
    step_msg, rows_msg = r0["errors"].tolist()
    assert "batch_size=15" in step_msg and "2 ranks" in step_msg
    assert "15 rows" in rows_msg and "2 ranks" in rows_msg


def test_resolve_layout_falls_back_and_refuses_mismatched_configs():
    from repro_torch.core import distributed as D
    binary = tcore.BSGDConfig(budget=500, batch_size=1)            # 501 slots
    assert D.resolve_layout(binary, "slots", 2) == "replicated"
    assert D.resolve_layout(tcore.BSGDConfig(budget=500, batch_size=8), "slots", 2) == "slots"
    mc = tcore.MulticlassSVMConfig(10, binary)
    assert D.resolve_layout(mc, "class", 2) == "class"
    assert D.resolve_layout(mc, "class", 4) == "replicated"
    with pytest.raises(TypeError, match="MulticlassSVMConfig"):
        D.resolve_layout(binary, "class", 2)
    with pytest.raises(TypeError, match="BSGDConfig"):
        D.resolve_layout(mc, "slots", 2)
    with pytest.raises(ValueError, match="layout"):
        D.resolve_layout(binary, "serve", 2)


def test_pick_backend_rule(monkeypatch):
    """NCCL only when every rank of the host has a card of its own."""
    from repro_torch.launch import dist as dist_launch
    assert dist_launch.pick_backend(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dist_launch.pick_backend(torch.device("cuda", 0), 1) == "nccl"
    assert dist_launch.pick_backend(torch.device("cuda", 0), 2) == "gloo"
