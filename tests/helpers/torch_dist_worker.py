"""One rank of the port's distributed CPU tests (``tests/test_torch_distributed.py``).

``run(rank, world, store, out_dir, cases)`` starts a gloo group on a
``FileStore`` (with a timeout, so a hung collective raises), runs every case
of ``cases`` on this rank and writes each case's result as
``<out_dir>/<case>-<rank>.npz``: the gathered state's leaves, this rank's
digest, the layout that ran, and the error text of a case that raised.  It
imports ``torch`` and ``repro_torch`` only: the JAX side of each comparison
runs in the test process.

Every case starts from ``warm_state(case)``, a state warmed by single-process
steps on the first rows so that maintenance fires in the distributed steps.
"""
from __future__ import annotations

import hashlib
import os
import traceback

import numpy as np
import torch

CPU = "cpu"
N, DIM, BATCH, WARM, STEPS = 128, 8, 16, 4, 2


def case_config(case):
    from repro_torch import core
    b = core.BSGDConfig(**case["kw"])
    return core.MulticlassSVMConfig(case["classes"], b) if case.get("classes") else b


def case_data(case):
    from repro_torch import data
    rng = np.random.default_rng(case.get("seed", 0))
    if case.get("classes"):
        return data.make_blobs_multiclass(rng, N, DIM, case["classes"], sep=1.0)
    return data.make_blobs(rng, N, DIM, sep=0.5)


def _labels(case, y):
    return torch.as_tensor(y, dtype=torch.int64 if case.get("classes") else torch.float32)


def single_step(case):
    """The single-process step function and its initial state for ``case``."""
    from repro_torch import core
    cfg = case_config(case)
    if case.get("classes"):
        return cfg, core.init_multiclass_state(cfg, DIM, device=CPU), core.train_step_multiclass
    return cfg, core.init_state(cfg, DIM, device=CPU), core.train_step


def warm_state(case):
    """``(state, x, y)``: the state after ``WARM`` single-process steps on the
    first rows, and the rows the distributed steps take after them."""
    cfg, state, step = single_step(case)
    x, y = case_data(case)
    table = cfg.table()
    for i in range(WARM):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        state = step(cfg, table, state, torch.as_tensor(x[sl]), _labels(case, y[sl]))
    return state, x[WARM * BATCH:], y[WARM * BATCH:]


def state_digest(state) -> str:
    """SHA-256 of ``convert.state_to_numpy(state)``, leaf by leaf: ranks that
    must hold the same state compare these."""
    from repro_torch import convert
    h = hashlib.sha256()
    for name, a in convert.state_to_numpy(state).items():
        h.update(name.encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _step_case(case, group):
    from repro_torch.core import distributed as D
    cfg = case_config(case)
    state, x, y = warm_state(case)
    world = torch.distributed.get_world_size(group)
    layout = D.resolve_layout(cfg, case["layout"], world)
    step = D.make_distributed_step(cfg, group, layout=case["layout"])
    part = D.shard_state(cfg, state, group, case["layout"])
    for i in range(STEPS):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        part = step(part, D.shard_rows(torch.as_tensor(x[sl]), group),
                    D.shard_rows(_labels(case, y[sl]), group))
    return D.gather_state(cfg, part, group, case["layout"]), layout, state_digest(part)


def _serve_case(case, group):
    from repro_torch import core
    from repro_torch.core import distributed as D
    cfg = case_config(case)
    state, x, _ = warm_state(case)
    model = core.export_model(state, cfg.binary.gamma if case.get("classes") else cfg.gamma,
                              bank_dtype=case.get("bank_dtype"))
    predict = D.make_distributed_predict(group)
    scores, labels = predict(model, D.shard_rows(torch.as_tensor(x), group))
    return {"scores": scores.numpy(), "labels": labels.numpy()}


def _stream_case(case, group, out_dir):
    from repro_torch import data
    from repro_torch.launch.train import svm_stream_loop
    x, y = case_data(case)
    source = data.ArrayChunks(x, y, case["chunk_rows"])
    ck = os.path.join(out_dir, f"ck-{case['name']}")
    kw = dict(layout=case["layout"], n_classes=case.get("classes") or 8, **case["loop"],
              seed=3, ckpt_dir=ck, ckpt_every=1, verbose=False, device=CPU, group=group)
    if case.get("kill_after"):
        svm_stream_loop(source, max_chunks=case["kill_after"], **kw)
    state, _ = svm_stream_loop(source, **kw)
    return state


def _error_case(group):
    """The batch that does not split: the step factory and ``shard_rows``."""
    from repro_torch import core
    from repro_torch.core import distributed as D
    msgs = []
    for fn in (lambda: D.make_distributed_step(core.BSGDConfig(budget=8, batch_size=15), group),
               lambda: D.shard_rows(torch.zeros(15, 3), group)):
        try:
            fn()
            msgs.append("no error")
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def run(rank: int, world: int, store: str, out_dir: str, cases) -> None:
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.launch import dist as dist_launch

    torch.set_num_threads(1)
    dist_launch.init(CPU, rank=rank, world_size=world, init_method=f"file://{store}",
                     timeout_s=120.0)
    group = dist.group.WORLD
    try:
        for case in cases:
            out = {}
            try:
                if case["kind"] == "step":
                    state, layout, digest = _step_case(case, group)
                    digests = [None] * world
                    dist.all_gather_object(digests, digest, group=group)
                    out = {**convert.state_to_numpy(state), "layout": layout,
                           "digests": np.array(digests)}
                elif case["kind"] == "serve":
                    out = _serve_case(case, group)
                elif case["kind"] == "stream":
                    out = convert.state_to_numpy(_stream_case(case, group, out_dir))
                else:
                    out = {"errors": np.array(_error_case(group))}
            except Exception:                 # recorded for the test to report
                out = {"error": traceback.format_exc()}
            np.savez(os.path.join(out_dir, f"{case['name']}-{rank}.npz"), **out)
        dist.barrier(group)
    finally:
        dist.destroy_process_group()
