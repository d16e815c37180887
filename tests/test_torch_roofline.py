"""The port's roofline (``repro_torch.launch.roofline``) against the reference's
(``repro.launch.roofline``), its counters on synthetic programs over a fake
process group, and the kernels' work formulas.

``Roofline.finalize``, ``model_flops`` and ``act_bytes_estimate`` must equal
the reference's at the reference's own constants, which the test reads from
``repro.launch.roofline`` into a ``DeviceSpec`` (one link rate for both of
the port's).  The counters must give the figures the reference's HLO
parsers give on its synthetic module (``tests/launch/test_plans_and_roofline.py``):
an all-gather of bf16[16, 2048], two all-reduces of bf16[16, 128] (one of
them async, counted once), a reduce-scatter to bf16[2, 128], and a matmul's
bytes proxy of 100 + 50 + 16*16*4 + 2*16*128*2.  The kernels' work formulas
live in the kernels layer (``repro_torch.kernels.work``), which imports
nothing of ``launch``.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.configs import SHAPES as JSHAPES
from repro.configs import get as jget
from repro.launch import roofline as jrl
from repro_torch.configs import ARCH_NAMES, SHAPES, get
from repro_torch.kernels import work as kw
from repro_torch.launch import roofline as rl

REF_SPEC = rl.DeviceSpec(name="reference", bf16_flops=jrl.PEAK_FLOPS, fp32_flops=jrl.PEAK_FLOPS,
                         hbm_bw=jrl.HBM_BW, hbm_bytes=jrl.HBM_BYTES, nvlink_bw=jrl.ICI_BW,
                         network_bw=jrl.ICI_BW)

RECORDS = [
    dict(arch="a", shape="s", mesh="16x16", strategy="tp", n_devices=256,
         flops_per_dev=1.97e12, bytes_per_dev=819e9 / 2, bytes_per_dev_raw=1e12,
         coll_bytes_per_dev=50e9 * 2, coll_breakdown={}, peak_mem_per_dev=0.0,
         arg_bytes_per_dev=1e9, act_bytes_est=1e9, model_flops_global=1.97e12 * 256 / 2),
    dict(arch="b", shape="t", mesh="2x16x16", strategy="fsdp", n_devices=512,
         flops_per_dev=3.1e13, bytes_per_dev=2.2e11, bytes_per_dev_raw=9e11,
         coll_bytes_per_dev=4.4e9, coll_breakdown={"all-gather": 4.4e9},
         peak_mem_per_dev=3e9, arg_bytes_per_dev=1.5e10, act_bytes_est=2e9,
         model_flops_global=9e15),
    dict(arch="c", shape="u", mesh="16x16", strategy="tp", n_devices=256, flops_per_dev=0.0,
         bytes_per_dev=1e6, bytes_per_dev_raw=1e6, coll_bytes_per_dev=0.0,
         coll_breakdown={}, peak_mem_per_dev=0.0, arg_bytes_per_dev=2e10, act_bytes_est=0.0,
         model_flops_global=0.0),
]
FIELDS = ("compute_s", "memory_s", "collective_s", "dominant", "useful_ratio", "fits_hbm",
          "step_s", "roofline_frac")


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_finalize_equals_reference_at_its_constants(i):
    want = jrl.Roofline(**RECORDS[i]).finalize()
    got = rl.Roofline(**RECORDS[i]).finalize(REF_SPEC)
    for f in FIELDS:
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12, abs=0), f
    assert set(dataclasses.asdict(want)) <= set(got.to_json())


def test_fits_traced_holds_the_traced_peak():
    # the reference's rule (arguments + analytic activations) says it fits;
    # the traced peak says it does not, and is the verdict
    over = rl.H100.hbm_bytes + 1
    rec = rl.Roofline(**{**RECORDS[0], "peak_mem_per_dev": over}).finalize()
    assert rec.fits_hbm and not rec.fits_traced
    rec = rl.Roofline(**{**RECORDS[0], "peak_mem_per_dev": rl.H100.hbm_bytes}).finalize()
    assert rec.fits_traced and rec.to_json()["fits_traced"]


def test_kernels_layer_imports_nothing_of_launch():
    import ast
    import pathlib

    import repro_torch.kernels as kernels

    for path in sorted(pathlib.Path(kernels.__file__).parent.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [("." * node.level) + (node.module or "")]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            for name in names:
                assert "launch" not in name.split("."), f"{path.name} imports {name}"


def test_finalize_on_the_card_splits_fp32_and_links():
    rec = rl.Roofline(**{**RECORDS[0], "flops_fp32_per_dev": 0.67e12,
                         "coll_bytes_cross_node": 50e9}).finalize()
    assert rec.device == "NVIDIA H100 80GB HBM3"
    assert rec.compute_s == pytest.approx((1.97e12 - 0.67e12) / 989e12 + 0.67e12 / 67e12)
    assert rec.collective_s == pytest.approx(50e9 / 450e9 + 50e9 / 50e9)
    assert rec.memory_s == pytest.approx(819e9 / 2 / 3.35e12)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_activations_equal_reference(arch):
    jcfg, cfg = jget(arch), get(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    for shape in SHAPES:
        assert rl.model_flops(cfg, shape, SHAPES) == jrl.model_flops(jcfg, shape, JSHAPES)
        for shards in (1, 16, 32):
            assert (rl.act_bytes_estimate(cfg, shape, SHAPES, shards)
                    == jrl.act_bytes_estimate(jcfg, shape, JSHAPES, shards))


def test_device_spec_names_the_card_and_refuses_others():
    spec = rl.device_spec("NVIDIA H100 80GB HBM3")
    assert spec is rl.H100
    assert (spec.bf16_flops, spec.fp32_flops, spec.hbm_bw) == (989e12, 67e12, 3.35e12)
    assert spec.hbm_bytes == 85_017_493_504 and spec.node_size == 8
    with pytest.raises(KeyError, match="no DeviceSpec"):
        rl.device_spec("NVIDIA A100-SXM4-80GB")


def test_rbf_thin_work_is_perf_bound_row():
    # PERF.md §6 row 1: rbf_thin at 1 x 501 x 123 fp32, 0.0743 us bound by bytes
    n_bytes, n_ops = kw.rbf_matrix_work(1, 501, 123, 4)
    assert n_bytes == (123 + 501 * 123 + 501) * 4 == 248_988
    secs, by = rl.bound_s((n_bytes, n_ops))
    assert by == "bytes" and round(secs * 1e6, 4) == 0.0743


def test_kernel_work_formulas():
    assert kw.table_cells(10, 400, 400) == 40 and kw.table_cells(10 ** 6, 400, 400) == 160_000
    assert kw.gss_work(501, 10) == (12.0 * 501, 501 * 306.0)
    b, o = kw.merge_pick_work(1, 501, 250, 40)
    assert b == 2 * 4 * 501 + 16 + 4 * 40 + 16 + 16 and o == 25.0 * 250 + 4.0 * 501
    b, o = kw.serve_cell_work(8, 10, 508, 780, 4, 2)
    assert b == 4 * 8 * 780 + 2 * 5080 * 780 + 4.0 * (5080 + 80 + 8)
    assert o == 2.0 * 8 * 5080 * 780 + 2.0 * (8 + 5080) * 780 + 7.0 * 8 * 5080 + 8 * 9
    b, o = kw.bdca_ascent_work(2, 8, [8, 4], 2)
    assert b == (64 + 16) * 4 + 2 * 8 * 8 + 8
    assert o == 2 * 64 + 2 * 8 * 24 + 2 * 16 + 2 * 4 * 16
    # merge_event_rounds of one round is merge_event's round plus the counters
    ev = kw.merge_event_work(3, 6, 4, 60, 3, 57, 20)
    rd = kw.merge_event_rounds_work(3, 6, 4, 60, [(60, 3, 57)], 20)
    assert rd[1] == ev[1]
    rd2 = kw.merge_event_rounds_work(3, 6, 4, 60, [(60, 3, 57), (40, 2, 30)], 20)
    assert rd2[0] - rd[0] == kw.event_round_bytes(40, 2, 6, 4)
    assert rd2[1] - rd[1] == kw.event_round_ops(40, 2, 30, 6)
    # the fused step's per-class counts: one number for every class, or C numbers
    one = kw.train_step_work(3, 64, 32, 8, 2, 8, 8, 8, 60, 1)
    each = kw.train_step_work(3, 64, 32, 8, 2, [8] * 3, [8] * 3, [8] * 3, [60] * 3, 1)
    assert one == each
    b, o = kw.train_step_work(2, 64, 32, 8, 2, [8, 0], [8, 0], [8, 0], [60, 50], 4)
    base = kw.train_step_work(2, 64, 32, 8, 2, 0, 0, 0, 0, 4)
    assert b - base[0] == 8 * 2 * 60 * 4 + 8 * (7 * 60 * 4 + 5 * 32 * 2)
    assert o - base[1] == 8 * 60 * (25.0 * 4 + 10.0)


# --------------------------------------------------------------------------- counters


@pytest.fixture(scope="module")
def fake_group():
    """A fake process group of 16 ranks in this process, gone after the module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=16, store=FakeStore())
    yield
    dist.destroy_process_group()


def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def test_counters_collectives_match_reference_parser(fake_group):
    from torch.distributed.device_mesh import init_device_mesh

    fn = torch.ops._c10d_functional
    mesh = init_device_mesh("cpu", (2, 8), mesh_dim_names=("data", "model"))
    world, model = dist.group.WORLD.group_name, mesh.get_group("model").group_name
    fm = _fake()
    with fm:
        p0 = torch.empty(16, 128, dtype=torch.bfloat16)
    counters = rl.Counters(fm)
    with counters, fm:
        fn.wait_tensor(fn.all_gather_into_tensor(p0, 16, world))          # (256, 128)
        fn.wait_tensor(fn.all_reduce(p0, "sum", world))
        work = dist.all_reduce(p0.clone(), async_op=True)                  # the async pair
        work.wait()
        fn.wait_tensor(fn.reduce_scatter_tensor(p0, "sum", 8, model))     # (2, 128)
    coll = counters.trace.coll
    assert coll["all-gather"] == 16 * 2048 * 2
    assert coll["all-reduce"] == 2 * 16 * 128 * 2
    assert coll["reduce-scatter"] == 2 * 128 * 2
    # the world spans two nodes of 8; the model axis's groups lie in one
    assert counters.trace.coll_cross == 16 * 2048 * 2 + 2 * 16 * 128 * 2


def test_counters_matmul_bytes_proxy_matches_reference(fake_group):
    fm = _fake()
    with fm:
        p0 = torch.empty(16, 128, dtype=torch.bfloat16)
    counters = rl.Counters(fm)
    with counters, fm:
        out = torch.mm(p0, p0.t(), out_dtype=torch.float32)
    assert out.dtype == torch.float32
    trace = counters.trace
    trace.arg_bytes, trace.out_bytes = 100, 50
    assert trace.fused_bytes() == 100.0 + 50.0 + 16 * 16 * 4 + 2 * 16 * 128 * 2
    assert trace.flops == 2 * 16 * 16 * 128


def test_counters_peak_live_bytes(fake_group):
    fm = _fake()
    with fm:
        a = torch.empty(1000)
    counters = rl.Counters(fm)
    with counters, fm:
        counters.resident([a])
        b = a * 2                     # 4,000 more
        c = b + 1                     # 4,000 more: 12,000 live
        del b
        d = c.view(10, 100) * 3       # b's bytes freed first: still 12,000
        del c, d
    assert counters.trace.arg_bytes == 4000
    assert counters.trace.peak_bytes == 12_000
    assert counters._now == 4000
