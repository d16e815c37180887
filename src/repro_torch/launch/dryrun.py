"""Multi-pod dry run: trace every (arch x shape x mesh) cell on one host.

PyTorch counterpart of ``repro.launch.dryrun``.  Run it as its own process
(``python -m repro_torch.launch.dryrun ...``): it makes the process rank 0
of a fake process group of 256 ranks (512 with ``--multi-pod``), on which
the production mesh is laid out, and ``launch/__init__.py`` never imports
it.  A cell's step runs once on fake tensors inside
``launch.roofline.Counters`` (``launch.steps.lower_cell``,
``core.distributed.lower_svm_cell``): nothing is allocated on a device and
no collective moves data.  Per cell it prints and records:
  * arguments, peak live and output bytes a device (does it fit the card);
  * FLOPs and the bytes proxy a device;
  * collective bytes a device by kind, and the three roofline terms on the
    ``roofline.H100`` spec.

The mesh and the fake tensors are on the card (``--device cuda``, the
default, which needs torch with CUDA; nothing is allocated there) or on the
CPU (``--device cpu``: DTensor on a CPU mesh; the SVM cell's kernels are
still planned, their fake tensors standing for the card's).

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek_v3_671b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--strategy fsdp]
  python -m repro_torch.launch.dryrun --arch svm_bsgd --svm-layout class --out DIR
  python -m repro_torch.launch.dryrun --arch smollm_360m --shape train_4k --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from ..configs import SHAPES, all_cells, get, registry
from . import roofline as rl
from .mesh import make_production_mesh
from .steps import lower_cell

# bytes a parameter holds while training in bf16 with AdamW: the parameter
# and its gradient (2 + 2) and the two float32 moments (4 + 4)
TRAIN_BYTES_PER_PARAM = 12
# bytes a bf16 weight holds for inference
INFER_BYTES_PER_PARAM = 2
TP_WAYS = 16          # the production mesh's model axis


def strategy_threshold(step: str, spec: rl.DeviceSpec = rl.H100) -> float:
    """The parameter count above which pure 16-way tp no longer fits.

    The reference's rule on its 16 GiB device: ZeRO-3/FSDP once a cell's
    per-device state under 16-way tp takes more than about half the
    device, the rest kept for activations.  Here from the spec's bytes: for
    training the parameters, gradients and AdamW moments
    (``TRAIN_BYTES_PER_PARAM``), for inference the weights
    (``INFER_BYTES_PER_PARAM``), over ``TP_WAYS`` ranks, against half of
    ``spec.hbm_bytes``: N * b / 16 <= hbm / 2.  On the H100 (85,017,493,504
    bytes) that is 56.7e9 parameters for training and 340.1e9 for
    inference (the reference's 8e9 and 60e9 on 16 GiB)."""
    b = TRAIN_BYTES_PER_PARAM if step == "train" else INFER_BYTES_PER_PARAM
    return spec.hbm_bytes / 2 * TP_WAYS / b


def choose_strategy(cfg, shape_name: str, strategy: str, spec: rl.DeviceSpec = rl.H100) -> str:
    if strategy != "auto":
        return strategy
    return ("fsdp" if cfg.param_count() > strategy_threshold(SHAPES[shape_name]["step"], spec)
            else "tp")


def _gib(n: float) -> str:
    return f"{n / 2 ** 30:.2f}GiB"


def _fits(rec, record) -> str:
    """The verdict: whether the traced peak (arguments included) fits the card."""
    hbm = rl.device_spec(rec.device).hbm_bytes
    return f"fits {_gib(hbm)} HBM: {rec.fits_traced} at the traced peak {_gib(record.peak_bytes)}"


def run_svm_cell(*, multi_pod: bool, method: str = "lookup-wd", out_dir: str | None = None,
                 budget: int = 16384, dim: int = 1024, batch: int = 8192, verbose=True,
                 layout: str = "replicated", n_classes: int = 8, stream_steps: int = 0,
                 step: str = "train", maintenance_engine: str = "xla",
                 step_engine: str = "composed", solver: str = "bsgd",
                 maintenance: str = "merge", device=None) -> dict:
    """The paper-technique cell: distributed minibatch BSGD on the mesh
    (``core.distributed.lower_svm_cell``, whose docstring states what its
    trace assumes).  The useful work is the (batch x slots x dim) kernel
    matrix, times ``n_classes`` for the class layout and ``stream_steps``
    for a chunk."""
    from ..core.distributed import lower_svm_cell

    mesh = make_production_mesh(multi_pod=multi_pod, device=device, fake=True)
    t0 = time.time()
    record, cfg = lower_svm_cell(mesh, budget=budget, dim=dim, batch=batch, method=method,
                                 layout=layout, n_classes=n_classes, stream_steps=stream_steps,
                                 step=step, maintenance_engine=maintenance_engine,
                                 step_engine=step_engine, solver=solver, maintenance=maintenance)
    t_lower = time.time() - t0
    model_flops = 2.0 * batch * (budget + batch) * dim
    if layout == "class":
        model_flops *= n_classes
    if stream_steps > 0:
        model_flops *= stream_steps
    rec = rl.analyze(record, arch=f"svm_bsgd_{method}", shape=f"b{budget}", mesh=mesh,
                     strategy="serve" if step == "predict" else layout,
                     model_flops_global=model_flops)
    result = rec.to_json()
    result.update(lower_s=round(t_lower, 1), multi_pod=multi_pod, scaled=record.scaled,
                  planned_launches={k: v["launches"] for k, v in record.kernels.items()})
    if verbose:
        print(f"[dryrun] svm_bsgd({method}) budget={budget} dim={dim} batch={batch} "
              f"mesh={rec.mesh}")
        print(f"  mem: args={_gib(record.arg_bytes)} "
              f"temp={_gib(record.peak_bytes - record.arg_bytes)}/dev ({_fits(rec, record)})")
        print(f"  roofline: compute={rec.compute_s * 1e3:.2f}ms "
              f"memory={rec.memory_s * 1e3:.2f}ms "
              f"collective={rec.collective_s * 1e3:.2f}ms dominant={rec.dominant} "
              f"useful={rec.useful_ratio:.2f} frac={rec.roofline_frac:.3f}")
        print(f"  planned launches: {result['planned_launches']} (scaled: {record.scaled})")
        print(f"  lower={t_lower:.1f}s")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"svm_bsgd_{method}.b{budget}.{'pod2' if multi_pod else 'pod1'}.{layout}"
        if stream_steps > 0:
            tag += f".stream{stream_steps}"
        if step == "predict":
            tag += ".predict"
        if maintenance != "merge":
            tag += f".{maintenance}"
        if maintenance_engine != "xla":
            tag += f".{maintenance_engine}"
        if step_engine != "composed":
            tag += ".fusedstep"
        if solver != "bsgd":
            tag += f".{solver}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, strategy: str,
             out_dir: str | None = None, verbose: bool = True, cfg_overrides: dict | None = None,
             tag_suffix: str = "", keep_scan: bool = False, device=None) -> dict:
    """Trace one (arch x shape) cell on the production mesh.  The port runs a
    model's layers one by one, so a trace counts every layer; the
    multi-pod pass and ``keep_scan`` trace the prefix and one scanned unit
    only (the reference's scanned form, whose counts take a scan body
    once: FLOPs and bytes then undercount, ``layers_traced`` says how far)."""
    cfg = dataclasses.replace(get(arch), **(cfg_overrides or {}))
    strat = choose_strategy(cfg, shape_name, strategy)
    n_layers = cfg.n_layers
    if multi_pod or keep_scan:
        cfg = dataclasses.replace(cfg, n_layers=cfg.prefix_layers + cfg.scan_unit)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device, fake=True)
    t0 = time.time()
    record, _ = lower_cell(cfg, shape_name, mesh, strategy=strat)
    t_lower = time.time() - t0
    rec = rl.analyze(record, arch=arch, shape=shape_name, mesh=mesh, strategy=strat,
                     model_flops_global=rl.model_flops(get(arch), shape_name, SHAPES),
                     act_bytes=rl.act_bytes_estimate(get(arch), shape_name, SHAPES,
                                                     mesh.size(mesh.mesh_dim_names.index("data"))))
    result = rec.to_json()
    result.update(lower_s=round(t_lower, 1), multi_pod=multi_pod,
                  layers_traced=f"{cfg.n_layers} of {n_layers}")
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} mesh={rec.mesh} strat={strat}")
        print(f"  memory: args={_gib(record.arg_bytes)} "
              f"temp={_gib(record.peak_bytes - record.arg_bytes)} "
              f"out={_gib(record.out_bytes)} per device "
              f"({_fits(rec, record)}; the reference's args + act_est rule: {rec.fits_hbm})")
        print(f"  counters: flops/dev={rec.flops_per_dev:.3e} bytes/dev={rec.bytes_per_dev:.3e}")
        print(f"  collectives/dev: {rec.coll_breakdown}")
        print(f"  roofline: compute={rec.compute_s * 1e3:.2f}ms "
              f"memory={rec.memory_s * 1e3:.2f}ms "
              f"collective={rec.collective_s * 1e3:.2f}ms "
              f"dominant={rec.dominant} useful={rec.useful_ratio:.2f} "
              f"frac={rec.roofline_frac:.3f}")
        print(f"  lower={t_lower:.1f}s layers traced {result['layers_traced']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}.{shape_name}.{'pod2' if multi_pod else 'pod1'}.{strat}{tag_suffix}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="auto", choices=["auto", "tp", "fsdp"])
    ap.add_argument("--svm-method", default="lookup-wd", help="solver for the svm_bsgd cell")
    ap.add_argument("--svm-layout", default="replicated",
                    choices=["replicated", "slots", "class"])
    ap.add_argument("--svm-classes", type=int, default=8,
                    help="n_classes for --svm-layout=class")
    ap.add_argument("--svm-stream-steps", type=int, default=0,
                    help="> 0: trace the streaming chunk program of that many steps")
    ap.add_argument("--svm-step", default="train", choices=["train", "predict"],
                    help="predict: trace the serve cell (the bank on every rank, the "
                         "request rows split)")
    ap.add_argument("--svm-engine", default="xla", choices=["xla", "pallas"],
                    help="pallas: the fused maintenance-event engine (merge_event_rounds)")
    ap.add_argument("--svm-step-engine", default="composed", choices=["composed", "pallas"],
                    help="pallas: the fused train-step kernel")
    ap.add_argument("--svm-solver", default="bsgd", choices=["bsgd", "bdca"],
                    help="bdca: the dual coordinate-ascent step (implies the kernel cache)")
    ap.add_argument("--svm-maintenance", default="merge",
                    choices=["merge", "multi-merge", "removal", "removal-project", "quantized"],
                    help="drain strategy for the svm_bsgd cell")
    ap.add_argument("--seq-shard-attn", action="store_true",
                    help="context-parallel attention")
    ap.add_argument("--keep-scan", action="store_true",
                    help="trace the prefix and one scanned unit only (fast; FLOPs and bytes "
                         "undercount, as the reference's scanned form does)")
    ap.add_argument("--tag-suffix", default="", help="suffix for the output json tag")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's and the fake tensors' device (cpu: for tests)")
    args = ap.parse_args(argv)
    overrides = {}
    if args.seq_shard_attn:
        overrides["seq_shard_attn"] = ("pod", "data") if args.multi_pod else ("data",)

    if args.arch == "svm_bsgd":
        run_svm_cell(multi_pod=args.multi_pod, method=args.svm_method, out_dir=args.out,
                     layout=args.svm_layout, n_classes=args.svm_classes,
                     stream_steps=args.svm_stream_steps, step=args.svm_step,
                     maintenance_engine=args.svm_engine, step_engine=args.svm_step_engine,
                     solver=args.svm_solver, maintenance=args.svm_maintenance,
                     device=args.device)
        return

    failures = []
    if args.all:
        for arch, shape, ok, reason in all_cells():
            if args.arch and arch != args.arch:
                continue
            if not ok:
                print(f"[dryrun] SKIP {arch} x {shape}: {reason}")
                continue
            try:
                run_cell(arch, shape, multi_pod=args.multi_pod, strategy=args.strategy,
                         out_dir=args.out, keep_scan=args.keep_scan, device=args.device)
            except Exception as e:  # noqa: BLE001 -- report, keep sweeping
                traceback.print_exc()
                failures.append((arch, shape, str(e)))
        if failures:
            print(f"[dryrun] {len(failures)} FAILURES: {failures}")
            raise SystemExit(1)
        print("[dryrun] all cells traced OK")
    else:
        cfg_ok, reason = registry.cell_applicable(get(args.arch), args.shape)
        if not cfg_ok:
            print(f"[dryrun] cell not applicable: {reason}")
            return
        run_cell(args.arch, args.shape, multi_pod=args.multi_pod, strategy=args.strategy,
                 out_dir=args.out, cfg_overrides=overrides, tag_suffix=args.tag_suffix,
                 keep_scan=args.keep_scan, device=args.device)


if __name__ == "__main__":
    main()
