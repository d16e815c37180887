"""Four of the ten architectures at their smoke configs, the port against
the reference (CPU, float32): Mamba-2, the Jamba hybrid and the two
DeepSeek MLA + MoE models (v3 with its sigmoid router and MTP loss).  The
cases are ``helpers.torch_lm_archs``'s."""
import pytest
from helpers.torch_lm import one_thread  # noqa: F401 (autouse fixture)
from helpers.torch_lm_archs import *  # noqa: F401,F403 (the shared cases)
from helpers.torch_lm_archs import make_arch_run

ARCHS = ["mamba2_130m", "jamba_v01_52b", "deepseek_v2_236b", "deepseek_v3_671b"]


@pytest.fixture(scope="module", params=ARCHS)
def arch_run(request):
    return make_arch_run(request.param)
