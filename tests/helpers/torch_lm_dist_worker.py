"""One rank of the port's distributed language-model tests
(``tests/test_torch_lm_distributed.py``).

``run(rank, world, store, out_dir)`` starts a gloo group on a ``FileStore``
(every collective under a timeout), runs each case on this rank and writes
``<out_dir>/<case>-<rank>.npz``, or the case's traceback as ``error``.  The
test process writes the inputs beforehand (``inputs.pt``); this module
imports ``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import os
import traceback

import numpy as np
import torch

CPU = "cpu"
ARCH, LR = "yi_9b", 1e-3
N_GROUPS, N_MICRO, MICRO, D = 8, 6, 4, 16


def body(w, x):
    return torch.tanh(x @ w)


def _dp_step(inputs, group):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.train import AdamW

    cfg = get_smoke(ARCH)
    model = LM(cfg, torch.device(CPU))
    model.load_state_dict(inputs["state_dict"])
    opt = AdamW(lr=LR)
    state = opt.init(dict(model.named_parameters()))
    state, loss = make_train_step(cfg, opt, group=group)(model, state, inputs["batch"])
    out = {"loss": loss.numpy()}
    out.update({f"p.{k}": p.detach().numpy() for k, p in model.named_parameters()})
    out.update({f"m.{k}": t.numpy() for k, t in state.m.items()})
    out.update({f"v.{k}": t.numpy() for k, t in state.v.items()})
    return out


def _compressed(inputs, group, rank):
    from repro_torch.train import compressed_psum

    grads = {k: v[rank] for k, v in inputs["grads"].items()}
    mean, resid = compressed_psum(grads, None, group)
    out = {f"mean.{k}": v.numpy() for k, v in mean.items()}
    out.update({f"resid.{k}": v.numpy() for k, v in resid.items()})
    return out


def _pipeline(inputs, group, world):
    from repro_torch.train import pipeline_forward

    out = pipeline_forward(body, world, inputs["ws"], inputs["x_micro"], group)
    stacked = pipeline_forward(lambda p, x: body(p["w"], x), world, {"w": inputs["ws"]},
                               inputs["x_micro"], group)
    return {"out": out.numpy(), "dict_params": stacked.numpy()}


def run(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch import dist as dist_launch

    torch.set_num_threads(1)
    dist_launch.init(CPU, rank=rank, world_size=world, init_method=f"file://{store}",
                     timeout_s=120.0)
    group = dist.group.WORLD
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    try:
        for name, fn in (("dp", lambda: _dp_step(inputs, group)),
                         ("compressed", lambda: _compressed(inputs, group, rank)),
                         ("pipeline", lambda: _pipeline(inputs, group, world))):
            try:
                out = fn()
            except Exception:                 # recorded for the test to report
                out = {"error": traceback.format_exc()}
            np.savez(os.path.join(out_dir, f"{name}-{rank}.npz"), **out)
        dist.barrier(group)
    finally:
        dist.destroy_process_group()
