"""The port's language-model trainer (``launch.train.train_loop`` and the
CLI's LM arm in process) and its token streams (``data.tokens``) on the CPU;
its child processes are ``test_torch_lm_launch.py``'s.

On the reference's own test config (smollm's smoke family at vocab 64, 2
layers, d 64; ``tests/test_system.py``) ``train_loop`` fed the reference's
initial weights and batches stays within ``TRAJ_TOL`` of the reference's
``train_loop`` over 20 steps: Adam's first steps move a weight by about
lr * sign(g), so gradients near 0 whose last bits differ part the two by up
to a step (ROADMAP's reasoning; the parts are held tightly in
``test_torch_lm_optim.py`` and ``test_torch_lm_grads*.py``).  Checkpoints
cross between the packages both ways; kill and resume is bit-equal.
"""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch
from helpers.torch_lm import f32, np_tree, one_thread  # noqa: F401 (autouse fixture)

from repro import checkpoint as jckpt
from repro.configs import get_smoke as jget_smoke
from repro.data.tokens import BigramStream as JBigramStream
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.data import BigramStream, frames_batch, random_batch, step_generator
from repro_torch.launch import train
from repro_torch.train import AdamW

TRAJ_TOL = 2e-3            # the reference's own resume tolerance (tests/test_system.py)


def _cfgs():
    kw = dict(vocab_size=64, n_layers=2, d_model=64)
    return (dataclasses.replace(jget_smoke("smollm_360m"), **kw),
            dataclasses.replace(get_smoke("smollm_360m"), **kw))


def _reference_batches(jcfg, seed: int, steps: int, batch: int, seq: int):
    """The reference train_loop's batches: its stream of ``seed``, step i's
    key ``fold_in(PRNGKey(seed + 1), i)``."""
    stream, base = JBigramStream(jcfg.vocab_size, seed=seed), jax.random.PRNGKey(seed + 1)
    out = []
    for i in range(steps):
        b = stream.batch(jax.random.fold_in(base, i), batch, seq)
        out.append({k: torch.from_numpy(np.array(v)) for k, v in b.items()})
    return out


def _reference_model(jcfg, tcfg, seed: int):
    params, _ = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    return convert.lm_params_from_numpy(tcfg, np_tree(params), device="cpu")


def test_train_loop_matches_reference():
    jcfg, tcfg = _cfgs()
    want = jtrain.train_loop(jcfg, steps=20, batch_size=4, seq_len=16, ckpt_dir=None,
                             verbose=False, seed=3)["losses"]
    batches = _reference_batches(jcfg, 3, 20, 4, 16)
    got = train.train_loop(tcfg, steps=20, batch_size=4, seq_len=16, verbose=False, seed=3,
                           device="cpu", model=_reference_model(jcfg, tcfg, 3),
                           batch_fn=batches.__getitem__)
    assert len(got["losses"]) == 20 and got["resumed_from"] is None
    assert got["final_loss"] == got["losses"][-1] and got["bigram_floor"] is None
    assert got["losses"][0] == pytest.approx(want[0], rel=1e-6)
    np.testing.assert_allclose(got["losses"], want, rtol=TRAJ_TOL, atol=TRAJ_TOL)


def test_lm_training_learns_bigram_structure():
    """The reference's ``test_lm_training_learns_bigram_structure`` on the
    port's own stream."""
    _, cfg = _cfgs()
    metrics = train.train_loop(cfg, steps=60, batch_size=8, seq_len=32, lr=5e-3, verbose=False,
                               seed=0, device="cpu")
    uniform = float(np.log(cfg.vocab_size))
    last = float(np.mean(metrics["losses"][-5:]))
    assert 0.0 < metrics["bigram_floor"] < uniform
    assert last < uniform - 0.25, (last, uniform, metrics["bigram_floor"])


def test_kill_and_resume_is_bit_equal(tmp_path):
    """An interrupted and resumed run equals an uninterrupted one bit for bit
    (the reference asks 2e-3): losses, parameters and optimizer state."""
    _, cfg = _cfgs()
    kw = dict(batch_size=4, seq_len=16, ckpt_every=10, verbose=False, seed=3, device="cpu")
    full = train.train_loop(cfg, steps=20, ckpt_dir=str(tmp_path / "a"), **kw)
    train.train_loop(cfg, steps=10, ckpt_dir=str(tmp_path / "b"), schedule_total=20, **kw)
    res = train.train_loop(cfg, steps=20, ckpt_dir=str(tmp_path / "b"), **kw)
    assert res["resumed_from"] == 10 and len(res["losses"]) == 10
    assert res["losses"] == full["losses"][10:]
    for (k, a), b in zip(full["model"].named_parameters(), res["model"].parameters()):
        assert torch.equal(a, b), k
    assert torch.equal(full["opt_state"].step, res["opt_state"].step)
    for k in full["opt_state"].m:
        assert torch.equal(full["opt_state"].m[k], res["opt_state"].m[k]), k
        assert torch.equal(full["opt_state"].v[k], res["opt_state"].v[k]), k


def test_schedule_total_is_the_schedules_horizon():
    """A leg of a longer job (``schedule_total``) trains its steps on the whole
    job's schedule: it equals the whole run's first steps, and not a run
    whose schedule ends with the leg."""
    _, cfg = _cfgs()
    kw = dict(batch_size=4, seq_len=16, verbose=False, seed=1, device="cpu")
    whole = train.train_loop(cfg, steps=8, **kw)["losses"]
    leg = train.train_loop(cfg, steps=4, schedule_total=8, **kw)["losses"]
    short = train.train_loop(cfg, steps=4, **kw)["losses"]
    assert leg == whole[:4] and short[0] == whole[0] and short[1:] != whole[1:4]


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's checkpoint at step 10 loads into the port exactly, and
    the port's next two steps on the reference's batches stay within
    ``TRAJ_TOL`` of the reference's own."""
    jcfg, tcfg = _cfgs()
    ck, ck_port = str(tmp_path / "ck"), str(tmp_path / "ck_port")
    jtrain.train_loop(jcfg, steps=10, batch_size=4, seq_len=16, ckpt_dir=ck, ckpt_every=10,
                      verbose=False, seed=3, schedule_total=12)
    shutil.copytree(ck, ck_port)
    params0, _ = jlm.init_lm(jax.random.PRNGKey(3), jcfg)
    saved = jckpt.load(ck, 10, {"params": params0, "opt": jopt.AdamW().init(params0)})
    model = _reference_model(jcfg, tcfg, 0)
    state = train._restore(ck_port, 10, tcfg, model,
                           AdamW().init(dict(model.named_parameters())))
    want = convert.lm_flat(tcfg, np_tree(saved["params"]))
    for k, p in model.named_parameters():
        assert np.array_equal(f32(p), f32(want[k])), k
    assert state.step.dtype == torch.int32 and int(state.step) == int(saved["opt"].step) == 10
    for moments, tree in ((state.m, saved["opt"].m), (state.v, saved["opt"].v)):
        for k, t in convert.lm_flat(tcfg, np_tree(tree)).items():
            assert np.array_equal(f32(moments[k]), f32(t)), k
    want_losses = jtrain.train_loop(jcfg, steps=12, batch_size=4, seq_len=16, ckpt_dir=ck,
                                    verbose=False, seed=3)["losses"]
    batches = _reference_batches(jcfg, 3, 12, 4, 16)
    got = train.train_loop(tcfg, steps=12, batch_size=4, seq_len=16, ckpt_dir=ck_port,
                           verbose=False, seed=3, device="cpu", batch_fn=batches.__getitem__)
    assert got["resumed_from"] == 10 and len(want_losses) == len(got["losses"]) == 2
    np.testing.assert_allclose(got["losses"], want_losses, rtol=TRAJ_TOL, atol=TRAJ_TOL)


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    """The port's checkpoint, read by ``repro.checkpoint.load`` into the
    reference's ``{"params", "opt"}`` tree, holds the port's state."""
    jcfg, tcfg = _cfgs()
    ck = str(tmp_path / "ck")
    got = train.train_loop(tcfg, steps=3, batch_size=4, seq_len=16, ckpt_dir=ck, verbose=False,
                           seed=2, device="cpu")
    params0, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jckpt.load(ck, 3, {"params": params0, "opt": jopt.AdamW().init(params0)})
    assert int(tree["opt"].step) == 3
    for k, t in convert.lm_flat(tcfg, np_tree(tree["params"])).items():
        assert np.array_equal(np.asarray(t), f32(got["model"].get_parameter(k))), k
    want = convert.opt_state_to_numpy(tcfg, got["opt_state"])
    for field in ("m", "v"):
        for k, t in convert._flat(want[field]).items():
            assert np.array_equal(np.asarray(convert._flat(getattr(tree["opt"], field))[k]), t), k


def test_watchdog_saves_and_exits_75(tmp_path, capsys):
    """Every step over its deadline: the second and third steps strike (the
    first is exempt) and the trainer saves step 3 and exits 75."""
    _, cfg = _cfgs()
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as exc:
        train.train_loop(cfg, steps=10, batch_size=2, seq_len=16, ckpt_dir=ck,
                         step_deadline_s=0.0, max_strikes=2, seed=0, device="cpu")
    assert exc.value.code == train.EX_TEMPFAIL == 75
    assert tckpt.latest_step(ck) == 3
    assert "STRAGGLER step 2" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["smollm_360m", "hubert_xlarge"])
def test_train_cli_trains_a_language_model(arch, tmp_path, capsys):
    """``--arch <lm> --smoke --device cpu``: tokens for the decoder, masked
    frames for the encoder; a checkpoint at the end."""
    ck = str(tmp_path / "ck")
    train.main(["--arch", arch, "--smoke", "--steps", "4", "--batch-size", "2", "--seq-len",
                "16", "--log-every", "1", "--ckpt-dir", ck, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[train] done: {arch} final loss" in out and "ranks=1" in out
    assert ("bigram floor None" in out) == (arch == "hubert_xlarge")
    assert out.count("[train] step ") == 4 and tckpt.latest_step(ck) == 4


def test_train_loop_trains_the_model_where_it_lives():
    """A model handed in trains on its own device; another device is refused."""
    _, cfg = _cfgs()
    model = train.train_loop(cfg, steps=1, batch_size=2, seq_len=8, verbose=False,
                             device="cpu")["model"]
    with pytest.raises(ValueError, match="model on cpu, training on meta"):
        train.train_loop(cfg, steps=1, batch_size=2, seq_len=8, verbose=False, device="meta",
                         model=model)


def test_train_cli_asks_for_the_card():
    with pytest.raises(RuntimeError, match="CUDA device"):
        train.main(["--arch", "smollm_360m", "--smoke", "--steps", "1"])


def test_bigram_stream_layouts_and_statelessness():
    stream = BigramStream(64, seed=0, device="cpu")
    assert stream.cdf.shape == (64, 64)
    np.testing.assert_allclose(stream.cdf[:, -1].numpy(), 1.0, rtol=1e-5)
    a = stream.batch(step_generator(1, 5, "cpu"), 3, 12)
    b = stream.batch(step_generator(1, 5, "cpu"), 3, 12)
    c = stream.batch(step_generator(1, 6, "cpu"), 3, 12)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["tokens"], c["tokens"])
    toks = a["tokens"]
    assert toks.dtype == torch.int64 and toks.shape == (3, 12)
    assert bool(((toks >= 0) & (toks < 64)).all())
    assert torch.equal(a["labels"], torch.roll(toks, -1, 1))
    assert a["mask"].dtype == torch.float32
    assert torch.equal(a["mask"][:, :-1], torch.ones(3, 11)) and not a["mask"][:, -1].any()
    # the floor is the table's mean row entropy
    p = torch.diff(stream.cdf, dim=1, prepend=torch.zeros(64, 1))
    assert stream.bigram_entropy() == pytest.approx(
        float(-(p * torch.log(p + 1e-12)).sum(1).mean()), rel=1e-4)
    # a long chain follows the table: empirical transitions of token 0
    long = stream.batch(step_generator(0, 0, "cpu"), 64, 400)["tokens"]
    src, dst = long[:, :-1].reshape(-1), long[:, 1:].reshape(-1)
    counts = torch.bincount(dst[src == 0], minlength=64).float()
    assert float((counts / counts.sum() - p[0]).abs().max()) < 0.1
    r = random_batch(step_generator(0, 1, "cpu"), 64, 2, 8)
    assert torch.equal(r["labels"], torch.roll(r["tokens"], -1, 1)) and r["mask"][:, -1].sum() == 0
    f = frames_batch(step_generator(0, 1, "cpu"), 2, 8, 5, 11)
    assert f["frames"].shape == (2, 8, 5) and f["frames"].dtype == torch.float32
    assert f["labels"].shape == (2, 8) and int(f["labels"].max()) < 11
    assert f["mask"].dtype == torch.bool and f["mask"].shape == (2, 8)
