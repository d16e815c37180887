"""The language models laid out on a ``DeviceMesh``: DTensor ``tp`` and
``fsdp`` steps, sharded AdamW moments, ``train_loop(mesh=)``, checkpoints
restored onto another mesh and context-parallel attention, on gloo CPU ranks.

One spawn of 4 CPU processes (``helpers.torch_lm_mesh_worker``, a 2 x 2
``("data", "model")`` mesh, the smallest that shards every spec; a gloo
group on a ``FileStore``, every collective under a timeout, the join under
a deadline) runs every case, then one spawn of 2 restores on a 1 x 2 mesh
what the 4 saved; each test reads its case's results.  Tolerances:

  * ``MESH_TOL`` (1e-5): the mesh against the port's one process, on the
    loss (relative) and on each leaf of ``m``, ``v`` and the gradients
    (of the leaf's max |.|; a family's gradients of the whole tree's);
    the updated parameters to the same 1e-5 wherever the step's gradient
    is at least ``COND_G`` (1e-5, 1,000 times AdamW's eps) and to ``2 *
    LR``, the most a step moves them, where it is smaller: there the first
    step's g / (|g| + eps) turns on the gradients' last bits;
  * the reference's single-device step at its own test's tolerances (loss
    1e-3, params 5e-2; ``tests/distributed/test_distributed.py``), and
    ``fsdp`` against ``tp`` at its loss 1e-3;
  * ``seq_shard_attn`` within 1e-4 of the loss without it
    (``tests/distributed/test_svm_and_ctxpar.py``);
  * the resumed leg within PR 24's elastic tolerance ``TRAJ_TOL`` (2e-3);
    a restored checkpoint array-equal.

The plain unit tests (``placements``, ``param_shardings``, the attributes
``distribute_model`` carries over, a 1 x 1 mesh's step bit-equal to the
unsharded one) run in this process on a one-rank gloo group.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from helpers import torch_lm_mesh_worker as W
from helpers.torch_lm import np_tree
from helpers.torch_lm_grads import lm_batch, port_grads, torch_batch

from repro.configs import get_smoke as jget_smoke
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.steps import make_train_step
from repro_torch.models import LM, init_lm
from repro_torch.sharding import specs as sh
from repro_torch.train import AdamW, global_norm
from repro_torch.train.optimizer import decays

WORLD, RESTORE_WORLD = 4, 2
JOIN_DEADLINE_S = 600.0
MESH_TOL = 1e-5
COND_G = 1e-5
SEQ_TOL = 1e-4
TRAJ_TOL = 2e-3
MESH_SIZES = {"data": 2, "model": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(cfg, n_parts: int) -> dict:
    """``2 * n_parts`` rows: ``lm_batch``'s (2, 16) batches of seeds 0.., as numpy."""
    parts = [lm_batch(cfg, seed=s) for s in range(n_parts)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _spawn(out, world: int, phase: str) -> None:
    """``world`` ranks of the worker, started with one hash seed
    (``launch.mesh.make_mesh`` refuses ranks that hash differently)."""
    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        ctx = mp.start_processes(W.run, args=(world, str(out / f"store-{phase}"), str(out),
                                              phase),
                                 nprocs=world, join=False, start_method="spawn")
    finally:
        if seed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = seed
    deadline = time.monotonic() + JOIN_DEADLINE_S
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"mesh workers ({phase}) did not finish in {JOIN_DEADLINE_S} s")


def _load(out, name: str, world: int) -> dict:
    for r in range(1, world):
        path = out / f"{name}-{r}.npz"
        if path.exists():
            pytest.fail(f"{name} on rank {r}: {np.load(path)['error']}")
    got = dict(np.load(out / f"{name}-0.npz"))
    assert "error" not in got, f"{name}: {got['error']}"
    return got


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, the one-process and reference results, and the ranks'."""
    out = tmp_path_factory.mktemp("lmmesh")
    yi_j, yi = jget_smoke("yi_9b"), get_smoke("yi_9b")
    yi_params, _ = jlm.init_lm(jax.random.PRNGKey(0), yi_j)
    coder_j, coder = jget_smoke("deepseek_coder_33b"), get_smoke("deepseek_coder_33b")
    coder_params, _ = jlm.init_lm(jax.random.PRNGKey(1), coder_j)
    yi_batch, coder_batch = _rows(yi, 4), _rows(coder, 4)
    families = {a: torch_batch(_rows(get_smoke(a), 2)) for a in W.FAMILIES}
    smollm = get_smoke("smollm_360m", dtype="float32")
    rng = np.random.default_rng(0)
    seq_batch = {"tokens": rng.integers(0, smollm.vocab_size, (8, 32)).astype(np.int64)}
    seq_batch["labels"] = np.roll(seq_batch["tokens"], -1, 1)
    shapes = {"w0": (8, 6), "w1": (4, 6), "w2": (6, 8), "w3": (5,)}
    clip_params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for k, s in shapes.items()}
    clip_grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for k, s in shapes.items()}
    torch.save({
        "yi": convert.lm_params_from_numpy(yi, np_tree(yi_params), device="cpu").state_dict(),
        "yi_batch": torch_batch(yi_batch),
        "coder": convert.lm_params_from_numpy(coder, np_tree(coder_params),
                                              device="cpu").state_dict(),
        "coder_batch": torch_batch(coder_batch), "families": families,
        "smollm": init_lm(smollm, seed=0, device="cpu").state_dict(),
        "seq_batch": torch_batch(seq_batch), "clip_params": clip_params,
        "clip_grads": clip_grads,
        "ckpt_w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}, out / "inputs.pt")
    _spawn(out, WORLD, "mesh")
    _spawn(out, RESTORE_WORLD, "restore")
    ranks = {name: _load(out, name, WORLD)
             for name in ("tp", "fsdp", "families", "seq", "clip", "ckpt")}
    ranks["restore"] = _load(out, "restore", RESTORE_WORLD)

    # the port's one process and the reference's single device
    opt = AdamW(lr=W.LR)
    one = convert.lm_params_from_numpy(yi, np_tree(yi_params), device="cpu")
    state, loss = make_train_step(yi, opt)(one, opt.init(dict(one.named_parameters())),
                                           torch_batch(yi_batch))
    jo = jopt.AdamW(lr=W.LR)
    jp, _, jloss = jax.jit(jmake_train_step(yi_j, jo))(yi_params, jo.init(yi_params),
                                                       jax.tree.map(jnp.asarray, yi_batch))
    return dict(out=out, ranks=ranks, coder=coder, families=families,
                clip=(clip_params, clip_grads),
                one=(dict(one.named_parameters()), state, float(loss)),
                reference=(convert.lm_flat(yi_j, np_tree(jp)), float(jloss)))


def _leaf_err(got, want, scale=None) -> float:
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) if scale is None else scale
    return float(np.max(np.abs(np.asarray(got, np.float32) - want)) / max(scale, 1e-30))


def _param_err(got, want, g) -> tuple[float, float]:
    """(error of the well-conditioned elements on the leaf's scale, the
    largest |difference| elsewhere) of an updated parameter."""
    want = np.asarray(want, np.float32)
    diff = np.abs(np.asarray(got, np.float32) - want)
    ok = np.abs(np.asarray(g, np.float32)) >= COND_G
    scale = max(float(np.max(np.abs(want))), 1e-30)
    return (float(diff[ok].max()) / scale if ok.any() else 0.0,
            float(diff[~ok].max()) if (~ok).any() else 0.0)


# ------------------------------------------------------------------ tp step
def test_tp_step_matches_one_process(setup):
    r = setup["ranks"]["tp"]
    params, state, loss = setup["one"]
    assert abs(float(r["loss"]) - loss) <= MESH_TOL * abs(loss)
    assert str(r["loss_placements"]) == "(Replicate(), Replicate())"
    for k, p in params.items():
        m = state.m[k].numpy()
        assert _leaf_err(r[f"m.{k}"], m) <= MESH_TOL, k
        assert _leaf_err(r[f"v.{k}"], state.v[k].numpy()) <= MESH_TOL, k
        g = m / (1 - AdamW().b1)                   # the clipped gradient of step 1
        good, rest = _param_err(r[f"p.{k}"], p.detach().numpy(), g)
        assert good <= MESH_TOL and rest <= 2 * W.LR, (k, good, rest)


def test_tp_step_matches_reference_single_device(setup):
    """The reference's ``test_dp_tp_train_step_matches_single_device``
    tolerances: loss 1e-3, every param within 5e-2."""
    r = setup["ranks"]["tp"]
    want, jloss = setup["reference"]
    assert abs(float(r["loss"]) - jloss) < 1e-3
    err = max(float(np.max(np.abs(r[f"p.{k}"] - np.asarray(v, np.float32))))
              for k, v in want.items())
    assert err < 5e-2, err


def test_tp_step_shards_by_the_specs(setup):
    """Each parameter and both moments hold the block the tp spec gives them."""
    r, cfg = setup["ranks"]["tp"], get_smoke("yi_9b")
    model = init_lm(cfg, device="cpu")
    for k, spec in sh.param_specs(model, MESH_SIZES, "tp").items():
        shape = list(model.get_parameter(k).shape)
        want = [n // (MESH_SIZES[e] if e else 1) for n, e in zip(shape, spec)]
        for what in "pmv":
            assert list(r[f"{what}shape.{k}"]) == want, (what, k, spec)
        assert r[f"mplace.{k}"] == r[f"pplace.{k}"] == r[f"vplace.{k}"], k


# ---------------------------------------------------------------- fsdp step
def test_fsdp_matches_tp(setup):
    """The reference's ``test_fsdp_strategy_matches_tp`` (losses within 1e-3),
    and the moments within ``MESH_TOL``: fsdp moves where tensors live, not
    what the step computes."""
    r = setup["ranks"]["fsdp"]
    assert abs(float(r["tp.loss"]) - float(r["fsdp.loss"])) < 1e-3
    assert abs(float(r["tp.loss"]) - float(r["fsdp.loss"])) <= MESH_TOL * abs(float(r["tp.loss"]))
    names = [k[len("tp.m."):] for k in r if k.startswith("tp.m.")]
    for k in names:
        assert _leaf_err(r[f"fsdp.m.{k}"], r[f"tp.m.{k}"]) <= MESH_TOL, k
        assert _leaf_err(r[f"fsdp.v.{k}"], r[f"tp.v.{k}"]) <= MESH_TOL, k


def test_fsdp_keeps_parameters_and_moments_sharded_over_data(setup):
    """Between steps every parameter with a ``data`` entry in its fsdp spec
    holds half that dim on a rank, and ``m`` and ``v`` share its placements."""
    r, cfg = setup["ranks"]["fsdp"], setup["coder"]
    model = init_lm(cfg, device="cpu")
    n_data = 0
    for k, spec in sh.param_specs(model, MESH_SIZES, "fsdp").items():
        shape = list(model.get_parameter(k).shape)
        want = [n // (MESH_SIZES[e] if e else 1) for n, e in zip(shape, spec)]
        for what in "pmv":
            assert list(r[f"fsdp.{what}shape.{k}"]) == want, (what, k, spec)
        assert r[f"fsdp.mplace.{k}"] == r[f"fsdp.pplace.{k}"] == r[f"fsdp.vplace.{k}"], k
        if "data" in spec:
            n_data += 1
            d = spec.index("data")
            assert r[f"fsdp.pshape.{k}"][d] * 2 == shape[d], k
    assert n_data == sum("embed" in p.axes for p in model.parameters())


# ----------------------------------------------------------- every family
@pytest.mark.parametrize("arch", W.FAMILIES)
def test_family_tp_step_matches_one_process(setup, arch):
    """Each smoke family's tp loss and gradients on the mesh against one
    process on the same weights (``init_lm(mesh=)`` draws what ``init_lm``
    on the CPU draws, bit for bit) and the same batch."""
    r = setup["ranks"]["families"]
    cfg = get_smoke(arch)
    model = init_lm(cfg, seed=W.FAMILY_SEED, device="cpu")
    for k, p in model.named_parameters():
        assert np.array_equal(r[f"{arch}.init.{k}"], p.detach().numpy()), k
    loss, grads = port_grads(cfg, model, setup["families"][arch])
    grads = {k: g.numpy() for k, g in grads.items()}
    assert abs(float(r[f"{arch}.loss"]) - loss) <= MESH_TOL * abs(loss)
    scale = max(float(np.max(np.abs(g))) for g in grads.values())
    for k, g in grads.items():
        assert _leaf_err(r[f"{arch}.g.{k}"], g, scale) <= MESH_TOL, k


# ---------------------------------------------------- context parallelism
@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_seq_shard_attn_preserves_numerics(setup, path):
    r = setup["ranks"]["seq"]
    assert abs(float(r[f"{path}.seq"]) - float(r[f"{path}.none"])) < SEQ_TOL


# ------------------------------------------------------------------- clip
def test_global_norm_and_a_binding_clip_on_a_mesh(setup):
    r = setup["ranks"]["clip"]
    params, grads = setup["clip"]
    gn = float(global_norm(grads))
    assert gn > 10 * W.CLIP
    assert abs(float(r["gn"]) - gn) <= 1e-6 * gn
    assert str(r["gn_placements"]) == "(Replicate(), Replicate())"
    params = {k: torch.nn.Parameter(v.clone()) for k, v in params.items()}
    opt = AdamW(lr=W.LR, clip_norm=W.CLIP)
    state = opt.update(grads, opt.init(params), params)
    for k, p in params.items():
        assert _leaf_err(r[f"m.{k}"], state.m[k].numpy()) <= 1e-6, k
        assert _leaf_err(r[f"v.{k}"], state.v[k].numpy()) <= 1e-6, k
        assert _leaf_err(r[f"p.{k}"], p.detach().numpy()) <= 1e-6, k


# ------------------------------------------------------------- checkpoints
def test_checkpoint_saved_on_4_ranks_restores_on_2(setup):
    """The reference's ``test_elastic_reshard_across_device_counts``: a tree
    sharded over 4 ranks, restored onto a 1 x 2 mesh, is array-equal."""
    r = setup["ranks"]["restore"]
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    assert int(r["step"]) == 5
    np.testing.assert_array_equal(r["w"], w)
    np.testing.assert_array_equal(r["b"], w[0])
    np.testing.assert_array_equal(r["w_local"], w[:4])          # rank 0's block
    assert str(r["w_places"]) == "(Replicate(), Shard(dim=0))"


def test_train_loop_on_a_mesh_resumes_on_another(setup):
    """``train_loop(mesh=)``: the interrupted run's first leg equals the whole
    run's steps, and its second leg, resumed on 2 ranks from the 4 ranks'
    checkpoint, equals the rest within ``TRAJ_TOL``."""
    c, r = setup["ranks"]["ckpt"], setup["ranks"]["restore"]
    leg = W.TRAIN["leg"]
    np.testing.assert_array_equal(c["leg"], c["whole"][:leg])
    assert int(r["resumed_from"]) == leg
    assert float(np.max(np.abs(r["resumed"] - c["whole"][leg:]))) <= TRAJ_TOL
    model = init_lm(get_smoke(W.TRAIN["arch"]), device="cpu")
    for k, spec in sh.param_specs(model, MESH_SIZES, "tp").items():
        shape = list(model.get_parameter(k).shape)
        want = [n // (MESH_SIZES[e] if e else 1) for n, e in zip(shape, spec)]
        assert list(c[f"pshape.{k}"]) == want, k


# ---------------------------------------------- in this process, no spawn
class _Names:
    """What ``placements`` and ``param_specs`` read of a mesh: its dim names
    and shape (a real 2 x 2 mesh needs 4 ranks)."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.mesh = torch.empty(tuple(sizes.values()))


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Names({"pod": 2, "data": 2, "model": 2})
    assert sh.placements((None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert sh.placements((("pod", "data"), None), mesh) == (Shard(0), Shard(0), Replicate())
    assert sh.placements(("data", "model", None), mesh) == (Replicate(), Shard(0), Shard(1))
    assert sh.placements((None, None), mesh) == (Replicate(),) * 3
    one = _Names({"data": 2, "model": 1})        # a dim of size 1 holds the whole
    assert sh.placements(("data", "model"), one) == (Shard(0), Replicate())
    with pytest.raises(ValueError, match="not a dim of the mesh"):
        sh.placements(("expert",), mesh)


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
def test_param_shardings_follow_param_specs(strategy):
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Names({"data": 2, "model": 2})
    model = LM(get_smoke("deepseek_v3_671b"), torch.device("meta"))
    specs = sh.param_specs(model, mesh, strategy)
    shardings = sh.param_shardings(model, mesh, strategy)
    assert shardings.keys() == specs.keys()
    for k, spec in specs.items():
        want = [Replicate(), Replicate()]
        for d, e in enumerate(spec):
            if e is not None:
                want[mesh.mesh_dim_names.index(e)] = Shard(d)
        assert shardings[k] == sh.NamedSharding(mesh, tuple(want)), k
    assert sh.to_shardings([specs], mesh) == [shardings]


def test_production_mesh_shapes(monkeypatch):
    calls = []
    monkeypatch.setattr(mesh_mod, "init_device_mesh",
                        lambda dev, shape, mesh_dim_names: calls.append(
                            (dev, shape, mesh_dim_names)))
    mesh_mod.make_production_mesh()
    mesh_mod.make_production_mesh(multi_pod=True)
    mesh_mod.make_production_mesh(device="cpu")
    assert calls == [("cuda", (16, 16), ("data", "model")),
                     ("cuda", (2, 16, 16), ("pod", "data", "model")),
                     ("cpu", (16, 16), ("data", "model"))]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process, and its 1 x 1 CPU mesh."""
    store = tmp_path_factory.mktemp("onerank") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield mesh_mod.make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "jamba_v01_52b"])
def test_distribute_model_carries_axes_and_scanned(one_rank, arch):
    cfg = get_smoke(arch)
    plain = init_lm(cfg, seed=2, device="cpu")
    model = sh.distribute_model(init_lm(cfg, seed=2, device="cpu"), one_rank, "fsdp")
    drawn = init_lm(cfg, seed=2, mesh=one_rank, strategy="fsdp")
    want = dict(plain.named_parameters())
    for got in (model, drawn):
        for k, p in got.named_parameters():
            q = want[k]
            assert isinstance(p, torch.nn.Parameter) and p.requires_grad
            assert p.axes == q.axes, k
            assert getattr(p, "scanned", False) == getattr(q, "scanned", False), k
            assert decays(p) == decays(q), k
            assert torch.equal(p.full_tensor(), q.detach()), k
        assert sh.param_specs(got, one_rank, "fsdp") == sh.param_specs(plain, one_rank, "fsdp")


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
def test_one_by_one_mesh_step_is_the_unsharded_step(one_rank, strategy):
    """On a 1 x 1 mesh every collective is the identity: the step is the
    unsharded one bit for bit, loss and every updated parameter."""
    cfg = get_smoke("smollm_360m")
    batch = torch_batch(_rows(cfg, 2))
    plain = init_lm(cfg, seed=3, device="cpu")
    model = init_lm(cfg, seed=3, mesh=one_rank, strategy=strategy)
    opt = AdamW(lr=W.LR)
    s1, l1 = make_train_step(cfg, opt)(plain, opt.init(dict(plain.named_parameters())), batch)
    s2, l2 = make_train_step(cfg, opt, mesh=one_rank, strategy=strategy)(
        model, opt.init(dict(model.named_parameters())), batch)
    assert torch.equal(l2.to_local(), l1)
    got = dict(model.named_parameters())
    for k, p in plain.named_parameters():
        assert torch.equal(got[k].full_tensor(), p.detach()), k
        assert torch.equal(s2.m[k].full_tensor(), s1.m[k]), k


def test_mesh_step_refuses_a_group_and_a_mesh(one_rank):
    with pytest.raises(ValueError, match="not both"):
        make_train_step(get_smoke("yi_9b"), group=dist.group.WORLD, mesh=one_rank)
    with pytest.raises(ValueError, match="unknown sharding strategy"):
        make_train_step(get_smoke("yi_9b"), mesh=one_rank, strategy="zero")
