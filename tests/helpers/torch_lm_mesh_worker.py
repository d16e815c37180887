"""One rank of the port's mesh tests (``tests/test_torch_lm_mesh.py``).

``run(rank, world, store, out_dir, phase)`` starts a gloo group on a
``FileStore`` (every collective under a timeout), makes the phase's
``DeviceMesh`` on the CPU, runs each of the phase's cases and writes
``<out_dir>/<case>-<rank>.npz``, or the case's traceback as ``error``.
Phase ``"mesh"`` runs on 4 ranks (a 2 x 2 ``("data", "model")`` mesh),
phase ``"restore"`` on 2 (a 1 x 2 mesh) from what the first wrote.  The
test process writes the inputs beforehand (``inputs.pt``); this module
imports ``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import os
import traceback

import numpy as np
import torch

CPU = "cpu"
LR = 1e-3
FAMILIES = ("smollm_360m", "yi_9b", "mamba2_130m", "jamba_v01_52b", "deepseek_v2_236b",
            "deepseek_v3_671b", "hubert_xlarge", "chameleon_34b", "h2o_danube3_4b",
            "deepseek_coder_33b")
FAMILY_SEED = 1
TRAIN = dict(arch="smollm_360m", steps=6, leg=3, batch_size=4, seq_len=16)
CLIP = 1e-2                       # binds: the gradients' global norm is far above it


def _model(cfg, state_dict):
    from repro_torch.models import LM

    model = LM(cfg, torch.device(CPU))
    model.load_state_dict(state_dict)
    return model


def _full(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).float().numpy()


def _layout(prefix: str, tensors: dict) -> dict:
    """Each DTensor's local shape and placements, by name."""
    out = {}
    for k, t in tensors.items():
        out[f"{prefix}shape.{k}"] = np.array(t.to_local().shape)
        out[f"{prefix}place.{k}"] = np.array(str(tuple(t.placements)))
    return out


def _step(cfg, model, mesh, strategy, batch, opt):
    from repro_torch.launch.steps import make_train_step

    params = dict(model.named_parameters())
    state = opt.init(params)
    state, loss = make_train_step(cfg, opt, mesh=mesh, strategy=strategy)(model, state, batch)
    out = {"loss": loss.to_local().numpy(), "loss_placements": np.array(str(loss.placements))}
    out.update({f"p.{k}": _full(p) for k, p in params.items()})
    out.update({f"m.{k}": _full(t) for k, t in state.m.items()})
    out.update({f"v.{k}": _full(t) for k, t in state.v.items()})
    out.update(_layout("p", params))
    out.update(_layout("m", state.m))
    out.update(_layout("v", state.v))
    return out


def _tp(inputs, mesh):
    from repro_torch.configs import get_smoke
    from repro_torch.sharding.specs import distribute_model
    from repro_torch.train import AdamW

    cfg = get_smoke("yi_9b")
    model = distribute_model(_model(cfg, inputs["yi"]), mesh, "tp")
    return _step(cfg, model, mesh, "tp", inputs["yi_batch"], AdamW(lr=LR))


def _fsdp(inputs, mesh):
    from repro_torch.configs import get_smoke
    from repro_torch.sharding.specs import distribute_model
    from repro_torch.train import AdamW

    cfg = get_smoke("deepseek_coder_33b")
    out = {}
    for strategy in ("tp", "fsdp"):
        model = distribute_model(_model(cfg, inputs["coder"]), mesh, strategy)
        got = _step(cfg, model, mesh, strategy, inputs["coder_batch"], AdamW(lr=LR))
        out.update({f"{strategy}.{k}": v for k, v in got.items()})
    return out


def _families(inputs, mesh):
    """Every smoke family's tp loss and gradients: ``SGD(lr=0)`` leaves the
    parameters as they are and its moment equal to the gradient."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_lm
    from repro_torch.train import SGD

    out = {}
    for arch in FAMILIES:
        cfg = get_smoke(arch)
        model = init_lm(cfg, seed=FAMILY_SEED, mesh=mesh, strategy="tp")
        init = {k: _full(p) for k, p in model.named_parameters()}
        got = _step(cfg, model, mesh, "tp", inputs["families"][arch], SGD(lr=0.0))
        out[f"{arch}.loss"] = got["loss"]
        for k, v in init.items():
            out[f"{arch}.init.{k}"] = v
            out[f"{arch}.g.{k}"] = got[f"m.{k}"]
    return out


def _seq(inputs, mesh):
    """``seq_shard_attn=("data",)`` against none: the loss of one step
    (``SGD(lr=0)``), at the reference test's shape and at a chunked one."""
    from repro_torch.configs import get_smoke
    from repro_torch.sharding.specs import distribute_model
    from repro_torch.train import SGD

    out = {}
    for name, over in (("dense", {}), ("chunked", {"attn_chunk": 16})):
        for seq in (None, ("data",)):
            cfg = get_smoke("smollm_360m", dtype="float32", seq_shard_attn=seq, **over)
            model = distribute_model(_model(cfg, inputs["smollm"]), mesh, "tp")
            got = _step(cfg, model, mesh, "tp", inputs["seq_batch"], SGD(lr=0.0))
            out[f"{name}.{'seq' if seq else 'none'}"] = got["loss"]
    return out


def _clip(inputs, mesh):
    """``global_norm`` of DTensor gradients and one AdamW update whose clip
    binds, on parameters sharded every way the specs shard them."""
    from repro_torch.sharding.specs import from_full
    from repro_torch.train import AdamW, global_norm
    from torch.distributed.tensor import Replicate, Shard

    ways = {"w0": (Shard(0), Shard(1)), "w1": (Replicate(), Shard(0)),
            "w2": (Shard(1), Replicate()), "w3": (Replicate(), Replicate())}
    params = {k: torch.nn.Parameter(from_full(inputs["clip_params"][k], mesh, pl))
              for k, pl in ways.items()}
    grads = {k: from_full(inputs["clip_grads"][k], mesh, pl) for k, pl in ways.items()}
    opt = AdamW(lr=LR, clip_norm=CLIP)
    state = opt.update(grads, opt.init(params), params)
    out = {"gn": _full(global_norm(grads)), "gn_placements": np.array(str(
        global_norm(grads).placements))}
    out.update({f"p.{k}": _full(p) for k, p in params.items()})
    out.update({f"m.{k}": _full(t) for k, t in state.m.items()})
    out.update({f"v.{k}": _full(t) for k, t in state.v.items()})
    return out


def _ckpt(inputs, mesh, out_dir):
    """A sharded tree saved on this mesh, and the trainer's legs: the whole
    run and the first leg of an interrupted one (resumed on 2 ranks)."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import train_loop
    from repro_torch.sharding.specs import from_full
    from torch.distributed.tensor import Shard

    w = inputs["ckpt_w"]
    tree = {"w": from_full(w, mesh, (Shard(0), Shard(1))), "b": from_full(w[0], mesh, (
        Shard(0), Shard(0)))}
    ckpt.save(os.path.join(out_dir, "tree"), 5, tree)
    cfg = get_smoke(TRAIN["arch"])
    kw = dict(batch_size=TRAIN["batch_size"], seq_len=TRAIN["seq_len"], ckpt_every=TRAIN["leg"],
              verbose=False, mesh=mesh, schedule_total=TRAIN["steps"])
    whole = train_loop(cfg, steps=TRAIN["steps"], ckpt_dir=os.path.join(out_dir, "whole"), **kw)
    leg = train_loop(cfg, steps=TRAIN["leg"], ckpt_dir=os.path.join(out_dir, "legs"), **kw)
    return {"whole": np.array(whole["losses"]), "leg": np.array(leg["losses"]),
            **_layout("p", dict(whole["model"].named_parameters()))}


def _restore(inputs, mesh, out_dir):
    """On 2 ranks: the 4-rank tree onto a 1 x 2 mesh, and the trainer resumed."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import train_loop
    from repro_torch.sharding.specs import NamedSharding
    from torch.distributed.tensor import Replicate, Shard

    w = inputs["ckpt_w"]
    target = {"w": ckpt.ShapeDtype(tuple(w.shape), w.dtype),
              "b": ckpt.ShapeDtype(tuple(w[0].shape), w.dtype)}
    shardings = {"w": NamedSharding(mesh, (Replicate(), Shard(0))), "b": None}
    step, tree = ckpt.restore_latest(os.path.join(out_dir, "tree"), target,
                                     shardings=shardings, device=CPU)
    cfg = get_smoke(TRAIN["arch"])
    resumed = train_loop(cfg, steps=TRAIN["steps"], ckpt_dir=os.path.join(out_dir, "legs"),
                         batch_size=TRAIN["batch_size"], seq_len=TRAIN["seq_len"],
                         ckpt_every=TRAIN["leg"], verbose=False, mesh=mesh,
                         schedule_total=TRAIN["steps"])
    return {"step": np.array(step), "w": _full(tree["w"]), "b": tree["b"].numpy(),
            "w_local": tree["w"].to_local().numpy(), "w_places": np.array(str(
                tuple(tree["w"].placements))),
            "resumed_from": np.array(resumed["resumed_from"]),
            "resumed": np.array(resumed["losses"])}


def run(rank: int, world: int, store: str, out_dir: str, phase: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch import dist as dist_launch
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist_launch.init(CPU, rank=rank, world_size=world, init_method=f"file://{store}",
                     timeout_s=120.0)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    if phase == "mesh":
        mesh = make_mesh((2, 2), ("data", "model"), device=CPU)
        cases = (("tp", lambda: _tp(inputs, mesh)), ("fsdp", lambda: _fsdp(inputs, mesh)),
                 ("families", lambda: _families(inputs, mesh)),
                 ("seq", lambda: _seq(inputs, mesh)), ("clip", lambda: _clip(inputs, mesh)),
                 ("ckpt", lambda: _ckpt(inputs, mesh, out_dir)))
    else:
        mesh = make_mesh((1, 2), ("data", "model"), device=CPU)
        cases = (("restore", lambda: _restore(inputs, mesh, out_dir)),)
    try:
        for name, fn in cases:
            try:
                out = fn()
            except Exception:                 # recorded for the test to report
                out = {"error": traceback.format_exc()}
            if rank == 0 or "error" in out:
                np.savez(os.path.join(out_dir, f"{name}-{rank}.npz"), **out)
            dist.barrier()
    finally:
        dist.destroy_process_group()

