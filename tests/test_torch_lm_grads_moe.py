"""Gradients of the two DeepSeek MLA + MoE architectures at their smoke
configs (v3 with its MTP loss), the port against ``jax.grad`` of the
reference (CPU, float32), at the reference test's no-drop MoE capacity.  The
cases are ``helpers.torch_lm_grads``'s; Mamba-2 and Jamba are in
``test_torch_lm_grads_ssm.py``, the MoE models at their default capacity in
``test_torch_lm_grads_drop.py``."""
import pytest
from helpers.torch_lm import one_thread  # noqa: F401 (autouse fixture)
from helpers.torch_lm_grads import *  # noqa: F401,F403 (the shared cases)
from helpers.torch_lm_grads import make_grad_run

ARCHS = ["deepseek_v2_236b", "deepseek_v3_671b"]


@pytest.fixture(scope="module", params=ARCHS)
def grad_run(request):
    return make_grad_run(request.param, "no_drop")
