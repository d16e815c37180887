"""Gradients of six of the ten architectures at their smoke configs, the port
against ``jax.grad`` of the reference (CPU, float32): the dense GQA decoders,
the sliding-window one, qk-norm and the encoder.  The cases are
``helpers.torch_lm_grads``'s; the MoE, MLA and SSM families, and one train
step against the reference's, are in ``test_torch_lm_grads_moe.py``."""
import pytest
from helpers.torch_lm import one_thread  # noqa: F401 (autouse fixture)
from helpers.torch_lm_grads import *  # noqa: F401,F403 (the shared cases)
from helpers.torch_lm_grads import make_grad_run

ARCHS = ["hubert_xlarge", "deepseek_coder_33b", "h2o_danube3_4b", "yi_9b", "smollm_360m",
         "chameleon_34b"]


@pytest.fixture(scope="module", params=ARCHS)
def grad_run(request):
    return make_grad_run(request.param)
