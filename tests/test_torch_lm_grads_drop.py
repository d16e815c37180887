"""Gradients of the three MoE architectures at their smoke configs and their
default capacity, where copies drop, the port against ``jax.grad`` of the
reference (CPU, float32).  The cases are ``helpers.torch_lm_grads``'s."""
import pytest
from helpers.torch_lm import one_thread  # noqa: F401 (autouse fixture)
from helpers.torch_lm_grads import *  # noqa: F401,F403 (the shared cases)
from helpers.torch_lm_grads import make_grad_run

ARCHS = ["jamba_v01_52b", "deepseek_v2_236b", "deepseek_v3_671b"]


@pytest.fixture(scope="module", params=ARCHS)
def grad_run(request):
    return make_grad_run(request.param, "default")
