"""Gradients of the two state-space architectures at their smoke configs,
Mamba-2 and the Jamba hybrid (Mamba-2 and attention layers, MoE FFNs at the
reference test's no-drop capacity), the port against ``jax.grad`` of the
reference (CPU, float32).  The cases are ``helpers.torch_lm_grads``'s."""
import pytest
from helpers.torch_lm import one_thread  # noqa: F401 (autouse fixture)
from helpers.torch_lm_grads import *  # noqa: F401,F403 (the shared cases)
from helpers.torch_lm_grads import make_grad_run

ARCHS = ["mamba2_130m", "jamba_v01_52b"]


@pytest.fixture(scope="module", params=ARCHS)
def grad_run(request):
    return make_grad_run(request.param, "no_drop")
