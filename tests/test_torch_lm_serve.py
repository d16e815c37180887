"""The port's language-model serving path against the reference (CPU).

``launch.serve.generate`` on the weights and prompt tokens of the
reference's ``serve(cfg, seed=0)`` gives that ``serve``'s tokens, token for
token (smollm_360m, h2o_danube3_4b with the prompt as long as its window so
the ring wraps on the first step, mamba2_130m; smoke configs).  One bf16
model (smollm_360m smoke in bf16) against the reference at 2e-2 of the
logits' scale: measured 6.7e-3 for the prefill and 5.5e-3 over 8 decode
steps, about one bf16 ulp at the logits' size (2**-7 relative), as the two
packages round bf16 chains at different places.  Then the refusals (the
encoder, a prompt longer than a sliding window), the CLI on the CPU, and
that it asks for the card by default.
"""
import numpy as np
import pytest
import torch
from helpers.torch_lm import (one_thread, reference_model, run_port,  # noqa: F401
                              run_reference, scale_err)

from repro.configs import get_smoke as jget_smoke
from repro.launch import serve as jserve
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as tserve

BF16_TOL = 2e-2
GEN = 8


@pytest.mark.parametrize("arch", ["smollm_360m", "h2o_danube3_4b", "mamba2_130m"])
def test_generate_equals_the_reference_serve(arch):
    import jax

    jcfg, tcfg = jget_smoke(arch), get_smoke(arch)
    prompt_len = 32          # h2o's smoke window is 32: the ring wraps at once
    want = np.asarray(jserve.serve(jcfg, batch=2, prompt_len=prompt_len, gen=GEN, seed=0,
                                   verbose=False))
    _, model = reference_model(jcfg, tcfg, seed=0)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(0), (2, prompt_len), 0,
                                       jcfg.vocab_size))
    timings = {}
    got = tserve.generate(tcfg, model, torch.from_numpy(toks), GEN, timings=timings)
    assert got.shape == (2, GEN + 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert timings["prefill_s"] > 0 and timings["decode_s"] > 0


def test_bf16_model_against_the_reference():
    jcfg, tcfg = jget_smoke("smollm_360m", dtype="bfloat16"), get_smoke("smollm_360m",
                                                                        dtype="bfloat16")
    params, model = reference_model(jcfg, tcfg)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    ref = run_reference(jcfg, params)
    port = run_port(tcfg, model, ref)
    assert port["last"].dtype == torch.bfloat16
    assert scale_err(port["last"], ref["last"]) < BF16_TOL
    assert scale_err(port["steps"], ref["steps"]) < BF16_TOL
    assert abs(float(port["loss"]) - float(ref["loss"])) < BF16_TOL


def test_serve_refuses_the_encoder():
    with pytest.raises(ValueError, match="encoder.*encode_step"):
        tserve.serve(get_smoke("hubert_xlarge"), device="cpu")


def test_prompt_longer_than_the_window_is_refused():
    """The reference's dynamic_update_slice cannot place a prefill cache
    larger than the ring; the port raises."""
    cfg = get_smoke("h2o_danube3_4b")                    # window 32
    with pytest.raises(ValueError, match="longer than the sliding window"):
        tserve.serve(cfg, batch=1, prompt_len=cfg.sliding_window + 16, gen=2, device="cpu",
                     verbose=False)


def test_serve_at_the_window_wraps_and_matches_a_full_forward():
    """prompt == window: the decode ring is the prefill cache itself, and the
    first step overwrites slot 0; the decoded logits equal a full forward's
    over the window that ends at each new token (the sliding-window rule)."""
    from repro_torch.models import forward, init_lm

    cfg = get_smoke("h2o_danube3_4b")
    model = init_lm(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)))
    out = tserve.generate(cfg, model, toks, 4)
    seq = torch.cat([toks, out[:, :4].long()], dim=1)
    with torch.no_grad():
        full, _ = forward(cfg, model, {"tokens": seq})
    np.testing.assert_array_equal(torch.argmax(full[:, 31:], -1).numpy(), out.numpy())


def test_serve_stats_and_cli_on_the_cpu(capsys):
    stats = {}
    out = tserve.serve(get_smoke("smollm_360m"), batch=2, prompt_len=16, gen=4, device="cpu",
                       stats=stats, verbose=False)
    assert out.shape == (2, 5) and int(out.max()) < get_smoke("smollm_360m").vocab_padded
    assert set(stats) == {"prefill_ms", "decode_ms_per_token", "tokens_per_s"}
    tserve.main(["--arch", "smollm_360m", "--smoke", "--batch", "2", "--prompt-len", "16",
                 "--gen", "4", "--device", "cpu"])
    line = capsys.readouterr().out
    assert "[serve] smollm_360m on cpu: prefill 2x16:" in line and "tokens/s" in line


def test_serve_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is reachable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "smollm_360m", "--smoke"])


def test_prefill_cache_placement():
    dst = torch.zeros(2, 6, 3)
    src = torch.ones(2, 4, 3)
    placed = tserve._place(dst, src)
    assert placed is dst and bool((dst[:, :4] == 1).all()) and bool((dst[:, 4:] == 0).all())
    same = torch.ones(2, 6, 3)
    assert tserve._place(torch.zeros(2, 6, 3), same) is same
    with pytest.raises(ValueError, match="does not fit"):
        tserve._place(torch.zeros(2, 3, 3), src)
