"""The port's dry-run planner (``launch.inputs``, ``launch.steps.plan_cell`` /
``lower_cell``, ``core.distributed.lower_svm_cell``, ``launch.dryrun``) against
the reference's, on the CPU.

* The abstract inputs have the reference's shapes and dtypes for every
  applicable cell of ``repro.configs.all_cells()`` (parameters by their port
  names through ``convert._layer_names``, the reference's scanned units
  unstacked), and so do the SVM chunk and serve specs.
* Plans run on a fake process group (``launch.mesh.start_fake_group``) in
  child processes, on CPU-typed meshes (a CUDA-typed mesh needs torch with
  CUDA): every family x {train, prefill, decode} on 2 x 4, as the
  reference's rehearsal lowers them; a (1, 1) plan's FLOPs equal
  ``FlopCounterMode`` on the real CPU step (no DTensor op counted twice);
  ``lower_svm_cell`` at the reference tests' reduced sizes under every
  layout, engine and solver, its kernels planned (fake tensors standing for
  the card's).
* Each kernel's planned branch allocates its plain version's output shapes
  and dtypes; a real tensor never takes it.
"""
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.configs import all_cells
from repro.configs import get as jget
from repro.launch import inputs as jinp
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, SHAPES, get
from repro_torch.launch import dryrun, inputs
from repro_torch.launch import roofline as rl

CHILD_TIMEOUT_S = 600


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


def _flat(tree) -> dict:
    """A reference tree of ShapeDtypeStructs as ``{dotted path: (shape, dtype)}``."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path):
            (tuple(x.shape), _dtype(np.dtype(x.dtype))) for path, x in leaves}


def _unstack(cfg, flat: dict) -> dict:
    """The reference's body leaves (a leading layer-group dim) per port layer."""
    out = {k: v for k, v in flat.items() if not k.startswith("body.")}
    groups = cfg.n_scan_groups
    for k, (shape, dt) in flat.items():
        if k.startswith("body."):
            assert shape[0] == groups, k
            a = np.empty(groups, dtype=object)
            for g in range(groups):
                a[g] = (shape[1:], dt)
            out[k] = a
    return convert._layer_names(cfg, out)


def _port(named) -> dict:
    return {k: (tuple(t.shape), _dtype(t.dtype)) for k, t in named}


CELLS = {}
for _a, _s, _ok, _ in all_cells():
    if _ok:
        CELLS.setdefault(_a, []).append(_s)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_inputs_match_reference(arch):
    jcfg, cfg = jget(arch), get(arch)
    shapes, _ = jinp.abstract_params(jcfg)
    model = inputs.abstract_params(cfg)
    params = dict(model.named_parameters())
    assert all(p.is_meta for p in params.values())
    want = _unstack(cfg, _flat(shapes))
    assert _port(params.items()) == want
    jopt = jinp.abstract_opt_state(jcfg, shapes)
    opt = inputs.abstract_opt_state(cfg, params)
    assert (tuple(opt.step.shape), _dtype(opt.step.dtype)) == ((), "int32")
    assert _flat({"s": jopt.step})["s"] == ((), "int32")
    for got, ref in ((opt.m, jopt.m), (opt.v, jopt.v)):
        assert _port(got.items()) == _unstack(cfg, _flat(ref))
    for shape in CELLS[arch]:
        got = _port(inputs.batch_specs(cfg, shape).items())
        assert got == _flat(jinp.batch_specs(jcfg, shape)), shape
        if SHAPES[shape]["step"] == "decode":
            jcache = _unstack(cfg, _flat(jinp.abstract_cache(jcfg, shape)))
            cache = inputs.abstract_cache(cfg, shape)
            assert len(cache) == cfg.n_layers
            for i, layer in enumerate(cache):
                for key, t in layer.items():
                    assert t.is_meta
                    assert ((tuple(t.shape), _dtype(t.dtype))
                            == tuple(jcache[f"layers.{i}.mixer.{key}"])), (shape, i, key)


@pytest.mark.parametrize("kw", [dict(), dict(n_classes=8), dict(x_dtype="bfloat16"),
                                dict(y_dtype="bfloat16", n_classes=None)])
def test_svm_specs_match_reference(kw):
    got = _port(inputs.svm_chunk_specs(32, 4, 16, **kw).items())
    assert got == _flat(jinp.svm_chunk_specs(32, 4, 16, **kw))
    n = kw.get("n_classes")
    for bank in ("bfloat16", "float32"):
        got = _port(inputs.svm_serve_specs(32, 16, 80, n_classes=n, bank_dtype=bank).items())
        assert got == _flat(jinp.svm_serve_specs(32, 16, 80, n_classes=n, bank_dtype=bank))


def test_choose_strategy_follows_the_spec():
    for step, per_param in (("train", 12), ("prefill", 2)):
        assert dryrun.strategy_threshold(step) == rl.H100.hbm_bytes / 2 * 16 / per_param
    picks = {}
    for arch in ARCH_NAMES:
        cfg = get(arch)
        for shape in ("train_4k", "decode_32k"):
            limit = rl.H100.hbm_bytes * 16 / (2 * (12 if shape == "train_4k" else 2))
            want = "fsdp" if cfg.param_count() > limit else "tp"
            assert dryrun.choose_strategy(cfg, shape, "auto") == want, (arch, shape)
            assert dryrun.choose_strategy(cfg, shape, "tp") == "tp"
            picks[arch, shape] = want
    assert picks["deepseek_v3_671b", "train_4k"] == "fsdp"
    assert picks["deepseek_v3_671b", "decode_32k"] == "fsdp"
    assert picks["deepseek_v2_236b", "decode_32k"] == "tp"
    assert picks["yi_9b", "train_4k"] == "tp"


# --------------------------------------------------------------------------- kernels


def _kernel_cases():
    from repro_torch.core.lookup import default_table
    from repro_torch.kernels import ops

    tab = default_table(400)
    g = torch.Generator().manual_seed(0)
    c, s, d, b, p = 3, 20, 6, 4, 2
    a = torch.randn(c, s, generator=g)
    full = torch.full((c,), s, dtype=torch.int32)
    zeros64 = torch.zeros(c, dtype=torch.int64)
    return {
        "rbf_matrix": (lambda t: ops.rbf_matrix(t[0], t[1], 0.5),
                       [torch.randn(5, d, generator=g), torch.randn(7, d, generator=g)]),
        "merge_scores": (lambda t: ops.merge_scores(*t, tab.wd_table),
                         [a[0], torch.rand(s, generator=g), torch.rand(s, generator=g) > 0.5,
                          a[0, :1].clone()]),
        "merge_pick": (lambda t: ops.merge_pick(*t, tab),
                       [a, torch.rand(c, s, generator=g), full, zeros64, a[:, 0].clone()]),
        "gss": (lambda t: ops.gss_solve(*t, n_iters=10),
                [torch.rand(s, generator=g), torch.rand(s, generator=g)]),
        "gss_pick": (lambda t: ops.gss_pick(*t, n_iters=10),
                     [a, torch.rand(c, s, generator=g), full, zeros64, a[:, 0].clone()]),
        "multi_merge_scores": (lambda t: ops.multi_merge_scores(*t, tab),
                               [a, torch.rand(c, p, s, generator=g),
                                torch.rand(c, p, s, generator=g) > 0.5,
                                torch.randn(c, p, generator=g)]),
        "multi_merge_choose": (lambda t: ops.multi_merge_choose(*t, s - 2, tab),
                               [a, torch.rand(c, p, s, generator=g),
                                torch.zeros(c, p, dtype=torch.int64),
                                torch.randn(c, p, generator=g), full]),
        "merge_event": (lambda t: ops.merge_event(*t, tab),
                        [torch.randn(c, s, d, generator=g), a.clone(),
                         torch.rand(c, s, s, generator=g), full,
                         torch.ones(c, dtype=torch.bool)]),
        "merge_event_rounds": (lambda t: ops.merge_event_rounds(*t, tab, rounds=2, budget=s - 2),
                               [torch.randn(c, s, d, generator=g), a.clone(),
                                torch.rand(c, s, s, generator=g), full.clone(),
                                torch.zeros(c, dtype=torch.int32)]),
        "train_step": (lambda t: ops.train_step(*t, tab, budget=s - b, lambda_=1e-3, gamma=0.5,
                                                batch_size=b),
                       [torch.randn(c, s, d, generator=g), a.clone(),
                        torch.rand(c, s, s, generator=g),
                        torch.full((c,), s - b, dtype=torch.int32),
                        torch.ones(c, dtype=torch.int32), torch.zeros(c, dtype=torch.int32),
                        torch.zeros(c, dtype=torch.int32), torch.randn(b, d, generator=g),
                        torch.ones(c, b), torch.rand(b, b, generator=g)]),
        "class_scores": (lambda t: ops.serve_cell(t[0], t[1], t[2], 0.5),
                         [torch.randn(b, d, generator=g), torch.randn(c, s, d, generator=g),
                          a.clone()]),
        "bdca_ascent": (lambda t: ops.bdca_ascent(t[0], t[1], t[2], 1.0, 2),
                        [a.clone(), torch.rand(c, s, s, generator=g), full]),
    }


def _meta(out) -> list:
    leaves = out if isinstance(out, (tuple, list)) else [out]
    return [(tuple(t.shape), t.dtype) for t in leaves]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("name", list(_kernel_cases()))
def test_kernel_planned_branch_allocates_the_plain_outputs(name, device):
    """A fake CUDA tensor (or, inside ``for_card``, a fake CPU one standing for
    it) takes the kernel's planned branch: the plain version's output shapes
    and dtypes, one planned launch, no real launch."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops, planned

    fn, ts = _kernel_cases()[name]
    want = _meta(fn([t.clone() for t in ts]))
    planned.reset()
    ops.reset_launch_counts()
    card = planned.for_card() if device == "cpu" else contextlib.nullcontext()
    with FakeTensorMode(allow_non_fake_inputs=True), card:
        fakes = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=device)
                 for t in ts]
        got = _meta(fn(fakes))
    assert got == want
    assert ops.planned_counts()[name] == 1 and sum(ops.planned_counts().values()) == 1
    assert not any(ops.launch_counts().values())


def test_real_tensors_never_take_the_planned_branch():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops, planned

    real = torch.zeros(3)
    for impl in ("auto", "ref"):
        assert ops._use_kernel(impl, real) is False
    with planned.for_card():
        assert ops._use_kernel("auto", real) is False
        assert ops._use_kernel("ref", real) is False
    with FakeTensorMode():
        fake_cpu, fake_cuda = torch.zeros(3), torch.zeros(3, device="cuda")
    assert ops._use_kernel("auto", fake_cpu) is False
    assert ops._use_kernel("auto", fake_cuda) == ops.PLAN
    assert ops._use_kernel("ref", fake_cuda) is False
    with planned.for_card():
        assert ops._use_kernel("auto", fake_cpu) == ops.PLAN
    planned.reset()
    with planned.for_card():
        k = ops.rbf_matrix(torch.ones(2, 3), torch.ones(4, 3), 0.5)
    assert k.shape == (2, 4) and not planned.is_fake(k) and planned.counts() == {}


# --------------------------------------------------------------------------- plans


def _child(code: str, subprocess_env) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=subprocess_env(1), timeout=CHILD_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


_PRELUDE = r"""
import json, torch
torch.set_num_threads(1)
from repro_torch.configs import SHAPES, get_smoke
from repro_torch.launch.mesh import make_mesh, start_fake_group
SHAPES.update({"train_4k": dict(seq_len=32, global_batch=8, step="train"),
               "prefill_32k": dict(seq_len=64, global_batch=8, step="prefill"),
               "decode_32k": dict(seq_len=64, global_batch=8, step="decode")})
"""


_FAMILY_CHILD = _PRELUDE + r"""
import sys
from repro_torch.launch.steps import lower_cell
start_fake_group(8)
mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
for arch in sys.argv[1:]:
    cfg = get_smoke(arch, remat=False)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        if cfg.is_encoder and shape == "decode_32k":
            continue
        rec, plan = lower_cell(cfg, shape, mesh, strategy="tp")
        print("CELL " + json.dumps(dict(arch=arch, shape=shape, kind=plan.kind,
                                        flops=rec.flops, coll=rec.coll, peak=rec.peak_bytes,
                                        arg=rec.arg_bytes, raw=rec.raw_bytes,
                                        proxy=rec.fused_bytes())))
"""


def test_every_family_plans_every_step(subprocess_env):
    """One arch a family x {train, prefill, decode} on a 2 x 4 CPU fake mesh
    (the reference's rehearsal; remat off, which only repeats forward ops),
    the families in three children at once."""
    groups = (["smollm_360m", "mamba2_130m", "hubert_xlarge"], ["jamba_v01_52b"],
              ["deepseek_v2_236b"])
    procs = [subprocess.Popen([sys.executable, "-c", _FAMILY_CHILD, *g], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=subprocess_env(1))
             for g in groups]
    cells = []
    for proc in procs:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
        assert proc.returncode == 0, err[-4000:]
        cells += [json.loads(ln[5:]) for ln in out.splitlines() if ln.startswith("CELL ")]
    assert len(cells) == 14
    for c in cells:
        assert c["flops"] > 0 or c["shape"] == "decode_32k", c
        assert c["peak"] >= c["arg"] > 0 and c["raw"] >= c["proxy"] > 0, c
        assert sum(c["coll"].values()) > 0, c         # a 2 x 4 layout communicates
        if c["kind"] == "train":
            assert c["coll"].get("all-reduce", 0) + c["coll"].get("reduce-scatter", 0) > 0


def test_one_rank_plan_counts_the_real_step(subprocess_env):
    """A (1, 1) plan and an unsharded plan count the FLOPs that FlopCounterMode
    counts on the real CPU step, exactly; the resident bytes are the real
    parameters', moments' and batch's."""
    out = _child(_PRELUDE + r"""
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch.steps import lower_cell, make_train_step
from repro_torch.models import init_lm
from repro_torch.train.optimizer import AdamW
start_fake_group(1)
mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
for arch in ["smollm_360m", "mamba2_130m", "deepseek_v2_236b", "hubert_xlarge"]:
    cfg = get_smoke(arch)
    rec, _ = lower_cell(cfg, "train_4k", mesh)
    rec0, _ = lower_cell(cfg, "train_4k", None, device="cpu")
    model = init_lm(cfg, seed=0, device="cpu")
    opt = AdamW()
    params = dict(model.named_parameters())
    state = opt.init(params)
    g = torch.Generator().manual_seed(0)
    b, s = 8, 32
    if cfg.input_kind == "frames":
        batch = {"frames": torch.randn(b, s, cfg.frame_dim, generator=g),
                 "labels": torch.randint(0, cfg.vocab_size, (b, s), generator=g).int(),
                 "mask": torch.rand(b, s, generator=g) < 0.5}
    else:
        tok = torch.randint(0, cfg.vocab_size, (b, s), generator=g).int()
        batch = {"tokens": tok, "labels": tok, "mask": torch.ones(b, s)}
    resident = sum(t.numel() * t.element_size() for t in
                   [*params.values(), *state.m.values(), *state.v.values(), state.step,
                    *batch.values()])
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, opt)(model, state, batch)
    print("ROW " + json.dumps(dict(arch=arch, mesh=rec.flops, plain=rec0.flops,
                                   real=fc.get_total_flops(), arg=rec.arg_bytes,
                                   arg0=rec0.arg_bytes, resident=resident,
                                   peak=rec.peak_bytes, peak0=rec0.peak_bytes)))
""", subprocess_env)
    rows = [json.loads(ln[4:]) for ln in out.splitlines() if ln.startswith("ROW ")]
    assert len(rows) == 4
    for r in rows:
        assert r["mesh"] == r["plain"] == r["real"] > 0, r
        assert r["arg"] == r["arg0"] == r["resident"], r
        assert r["peak"] > r["arg"] and r["peak0"] > r["arg0"], r


SVM_CASES = [dict(), dict(layout="slots"), dict(layout="class"),
             dict(layout="class", maintenance_engine="pallas"),
             dict(layout="class", step_engine="pallas"), dict(layout="class", solver="bdca"),
             dict(solver="bdca"), dict(step="predict"), dict(step="predict", layout="class"),
             dict(stream_steps=4), dict(stream_steps=4, layout="class"), dict(method="gss"),
             dict(maintenance="multi-merge"), dict(maintenance="removal"),
             dict(maintenance="removal-project"), dict(maintenance="quantized")]


def test_lower_svm_cell_every_layout_engine_and_solver(subprocess_env):
    """The reference tests' reduced cell (budget 64, dim 32, batch 16, 8
    classes) on 8 fake ranks: the kernels each path launches, planned with
    the stated round counts; the class layout's fused step adds no
    collective over the event-engine cell."""
    out = _child(r"""
import json, torch
torch.set_num_threads(1)
from repro_torch.core.distributed import lower_svm_cell
from repro_torch.launch.mesh import make_mesh, start_fake_group
start_fake_group(8)
mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
for kw in %r:
    rec, cfg = lower_svm_cell(mesh, budget=64, dim=32, batch=16, n_classes=8, **kw)
    print("SVM " + json.dumps(dict(kw=kw, flops=rec.flops, coll=rec.coll, scaled=rec.scaled,
                                   launches={k: v["launches"] for k, v in rec.kernels.items()},
                                   arg=rec.arg_bytes, peak=rec.peak_bytes)))
try:     # a cuda-typed mesh where torch has no CUDA: refused, not planned on the CPU
    lower_svm_cell(make_mesh((2, 4), ("data", "model"), device="cuda"), budget=64, dim=32,
                   batch=16)
except RuntimeError as e:
    print("CUDA MESH " + str(e))
""" % (SVM_CASES,), subprocess_env)
    assert "CUDA MESH a plan on a cuda-typed mesh needs torch built with CUDA" in out
    rows = [json.loads(ln[4:]) for ln in out.splitlines() if ln.startswith("SVM ")]
    assert [r["kw"] for r in rows] == SVM_CASES
    by = {json.dumps(r["kw"], sort_keys=True): r for r in rows}

    def row(**kw):
        return by[json.dumps(kw, sort_keys=True)]

    for r in rows:
        assert r["flops"] > 0 and r["peak"] >= r["arg"] > 0, r
        if r["kw"].get("step") != "predict":
            assert r["scaled"]["maintenance_rounds"] == 16, r
    assert row()["launches"] == {"rbf_matrix": 1 + 16, "merge_pick": 16}   # a kappa row a round
    assert row(method="gss")["launches"] == {"rbf_matrix": 17, "gss_pick": 16}
    assert row(maintenance="multi-merge")["launches"] == {"rbf_matrix": 17,
                                                          "multi_merge_choose": 16}
    assert row(layout="class", maintenance_engine="pallas")["launches"] == {
        "rbf_matrix": 2, "merge_event_rounds": 1}
    assert row(layout="class", step_engine="pallas")["launches"] == {"rbf_matrix": 1,
                                                                      "train_step": 1}
    assert row(solver="bdca")["launches"]["bdca_ascent"] == 1
    assert row(step="predict")["launches"] == {"class_scores": 1}
    assert row(stream_steps=4)["launches"] == {"rbf_matrix": 4 * 17, "merge_pick": 4 * 16}
    assert row(stream_steps=4)["scaled"]["chunk_steps"] == 4
    assert (row(layout="class", step_engine="pallas")["coll"]
            == row(layout="class", maintenance_engine="pallas")["coll"])
    assert row()["coll"]["all-gather"] > 0 and row(layout="slots")["coll"]["all-reduce"] > 0


def test_dryrun_cli_on_the_cpu(tmp_path, subprocess_env):
    """``python -m repro_torch.launch.dryrun`` on the 16 x 16 fake mesh: the SVM
    cell and an LM cell (``--keep-scan``: one layer traced), their JSON tags."""
    env = subprocess_env(1)
    for args, tag in ((["--arch", "svm_bsgd"], "svm_bsgd_lookup-wd.b16384.pod1.replicated"),
                      (["--arch", "smollm_360m", "--shape", "decode_32k", "--keep-scan"],
                       "smollm_360m.decode_32k.pod1.tp")):
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                              "--device", "cpu", "--out", str(tmp_path)], capture_output=True,
                             text=True, env=env, timeout=CHILD_TIMEOUT_S)
        assert out.returncode == 0, out.stderr[-4000:]
        assert out.stdout.startswith("[dryrun]") or "[dryrun]" in out.stdout
        rec = json.loads((tmp_path / f"{tag}.json").read_text())
        assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
        assert rec["device"] == "NVIDIA H100 80GB HBM3" and rec["step_s"] > 0
    assert rec["layers_traced"] == "1 of 32"


def test_dryrun_is_not_imported_by_the_launch_package():
    """``launch.dryrun`` starts a fake process group: only its own process runs it."""
    import ast

    import repro_torch.launch as launch

    tree = ast.parse(open(launch.__file__).read())
    assert not [n for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))]
