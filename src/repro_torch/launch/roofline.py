"""Three-term roofline of a planned step on the card, and the counters that plan it.

PyTorch counterpart of ``repro.launch.roofline``.  The reference reads a
compiled XLA artifact (``cost_analysis``, ``memory_analysis``, the HLO
text); here a step is run once on fake tensors (``launch.steps.lower_cell``,
``core.distributed.lower_svm_cell``) inside ``Counters``, a
``TorchDispatchMode`` that takes its place:

  * FLOPs a device: ``torch.utils.flop_counter``'s formulas on the ops a rank
    runs on its own blocks.  An op on DTensors is not counted (DTensor then
    runs it as local ops, which are); nor is an op on another fake mode's
    tensors (DTensor's sharding propagation), so no FLOP is counted twice.
  * Bytes a device, ``fused_bytes``'s rule: the operands and results of the
    matmul, convolution, attention, gather/index, scatter, sort and
    reduction ops, plus one read of the step's inputs and one write of its
    outputs (a fused elementwise chain streams nothing of its own).  Beside
    it ``bytes_per_dev_raw``, every op's operands and results.
  * Collective bytes by kind: each collective's result bytes, the functional
    ops DTensor issues (``_c10d_functional.*``, an async pair counted once:
    ``wait_tensor`` is not a collective) and the in-place ``c10d`` ops of
    ``dist.all_gather``/``dist.all_reduce``; those whose group spans more
    than one node of ``node_size`` ranks are kept apart.
  * Peak live bytes a device: every storage alive at once, the step's
    arguments included, from the fake tensors' allocations and frees.
  * The hand-written kernels: under a plan each ``kernels/*.py`` wrapper
    allocates its outputs and reports its work (``kernels.planned``, by the
    formulas below), which the counters add to the FLOPs and both byte sums.

A region run once in place of ``r`` identical rounds (``kernels.planned.
scaled``: one traced maintenance round for a step's masked rounds) counts
``r`` times; its live bytes count once.

The card is a ``DeviceSpec``; ``H100`` is the one the port targets.  The
kernels' work formulas (``kernels.work``: bytes each input read once and
each output written once, and fp32 operations) are the ones behind PERF.md
§6's bound column; ``bound_s`` turns one into the least time the card takes.
"""
from __future__ import annotations

import dataclasses
import json
import time
import weakref

import torch

from ..kernels import planned

# --------------------------------------------------------------------------- the card


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One card's rates.  Rates are per card; ``nvlink_bw`` is one direction
    of its NVLink inside a node of ``node_size`` cards, ``network_bw`` its
    share of the network between nodes."""

    name: str
    bf16_flops: float          # dense bf16 tensor-core peak, FLOP/s
    fp32_flops: float          # fp32 outside the tensor cores, FLOP/s
    hbm_bw: float              # device memory, B/s
    hbm_bytes: int             # device memory, bytes
    nvlink_bw: float           # B/s, inside a node
    network_bw: float          # B/s, between nodes
    node_size: int = 8


# NVIDIA H100 80GB HBM3 (SXM5), as `nvidia-smi` names it, at its 700.00 W
# power limit (the published rates assume the full limit):
#   bf16_flops  989e12    H100 SXM data sheet, dense bf16 tensor core (1,979 with sparsity)
#   fp32_flops  67e12     H100 SXM data sheet, fp32 outside the tensor cores
#   hbm_bw      3.35e12   H100 SXM data sheet, HBM3 bandwidth
#   hbm_bytes   85,017,493,504  the card itself: torch.cuda.get_device_properties(0)
#               .total_memory on that card under torch 2.11 (chip_smoke.py phase 23 prints it)
#   nvlink_bw   450e9     H100 SXM data sheet: NVLink 900 GB/s a card, both directions
#   network_bw  50e9      DGX H100 data sheet: one 400 Gb/s ConnectX-7 port a card
H100 = DeviceSpec(name="NVIDIA H100 80GB HBM3", bf16_flops=989e12, fp32_flops=67e12,
                  hbm_bw=3.35e12, hbm_bytes=85_017_493_504, nvlink_bw=450e9, network_bw=50e9)
SPECS = {H100.name: H100}


def device_spec(name: str) -> DeviceSpec:
    """The spec of the card ``nvidia-smi`` (or ``torch.cuda.get_device_name``)
    calls ``name``; raises ``KeyError`` for a card without one."""
    try:
        return SPECS[name]
    except KeyError:
        raise KeyError(f"no DeviceSpec for the card {name!r}; known: {sorted(SPECS)}") from None


# --------------------------------------------------------------------------- the record


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    strategy: str
    n_devices: int
    flops_per_dev: float
    bytes_per_dev: float           # fusion-aware proxy (see Counters)
    bytes_per_dev_raw: float       # every op's operands and results (upper bound)
    coll_bytes_per_dev: float
    coll_breakdown: dict
    peak_mem_per_dev: float        # peak live bytes of the traced step, arguments included
    arg_bytes_per_dev: float
    act_bytes_est: float = 0.0     # analytic activation estimate
    model_flops_global: float = 0.0
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0
    fits_hbm: bool = True
    step_s: float = 0.0
    roofline_frac: float = 0.0
    flops_fp32_per_dev: float = 0.0    # of flops_per_dev, those in fp32 (the fp32 rate)
    coll_bytes_cross_node: float = 0.0  # of coll_bytes_per_dev, groups spanning nodes
    device: str = ""
    fits_traced: bool = True           # the traced peak fits the card's memory

    def finalize(self, spec: DeviceSpec = H100):
        self.device = spec.name
        self.compute_s = ((self.flops_per_dev - self.flops_fp32_per_dev) / spec.bf16_flops
                          + self.flops_fp32_per_dev / spec.fp32_flops)
        self.memory_s = self.bytes_per_dev / spec.hbm_bw
        self.collective_s = ((self.coll_bytes_per_dev - self.coll_bytes_cross_node)
                             / spec.nvlink_bw + self.coll_bytes_cross_node / spec.network_bw)
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        total = self.flops_per_dev * self.n_devices
        self.useful_ratio = self.model_flops_global / total if total else 0.0
        # fits_hbm is the reference's rule (the arguments and the analytic
        # activations); fits_traced, the verdict, holds the traced peak
        self.fits_hbm = (self.act_bytes_est + self.arg_bytes_per_dev) <= spec.hbm_bytes
        self.fits_traced = self.peak_mem_per_dev <= spec.hbm_bytes
        # overlap model: compute overlaps with memory AND collectives at best
        self.step_s = max(terms.values())
        ideal_s = self.model_flops_global / (self.n_devices * spec.bf16_flops)
        self.roofline_frac = ideal_s / self.step_s if self.step_s else 0.0
        return self

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def act_bytes_estimate(cfg, shape_name: str, shapes: dict, n_data_shards: int) -> float:
    """Per-device activation memory: the bf16 residual kept a layer under
    remat plus an 8x-residual transient for train, the transient for
    prefill, negligible for decode."""
    sh = shapes[shape_name]
    tokens_dev = sh["global_batch"] * sh["seq_len"] / n_data_shards
    resid = tokens_dev * cfg.d_model * 2
    if sh["step"] == "train":
        return float(cfg.n_layers * resid + 8 * resid)
    if sh["step"] == "prefill":
        return float(8 * resid)
    return float(2 * cfg.d_model * sh["global_batch"] * 8)


def model_flops(cfg, shape_name: str, shapes: dict) -> float:
    """6*N_active*tokens for train, 2*N_active*tokens for inference."""
    sh = shapes[shape_name]
    n = cfg.active_param_count()
    if sh["step"] == "train":
        return 6.0 * n * sh["global_batch"] * sh["seq_len"]
    if sh["step"] == "prefill":
        return 2.0 * n * sh["global_batch"] * sh["seq_len"]
    return 2.0 * n * sh["global_batch"]          # one new token a sequence


def analyze(record: "Trace", *, arch: str, shape: str, mesh, strategy: str,
            model_flops_global: float, act_bytes: float = 0.0,
            spec: DeviceSpec = H100) -> Roofline:
    """The roofline of a traced step (``lower_cell``'s or ``lower_svm_cell``'s record)."""
    sizes = _mesh_sizes(mesh)
    n_dev = 1
    for v in sizes:
        n_dev *= v
    r = Roofline(
        arch=arch, shape=shape, mesh="x".join(map(str, sizes)), strategy=strategy,
        n_devices=n_dev, flops_per_dev=record.flops, bytes_per_dev=record.fused_bytes(),
        bytes_per_dev_raw=record.raw_bytes, coll_bytes_per_dev=float(sum(record.coll.values())),
        coll_breakdown=dict(record.coll), peak_mem_per_dev=float(record.peak_bytes),
        arg_bytes_per_dev=float(record.arg_bytes), act_bytes_est=act_bytes,
        model_flops_global=model_flops_global, flops_fp32_per_dev=record.flops_fp32,
        coll_bytes_cross_node=record.coll_cross)
    return r.finalize(spec)


def save_record(rec: Roofline, path: str) -> None:
    with open(path, "w") as f:
        json.dump(rec.to_json(), f, indent=2)


def _mesh_sizes(mesh) -> tuple:
    if mesh is None:
        return (1,)
    if isinstance(mesh, dict):
        return tuple(mesh.values())
    return tuple(mesh.mesh.shape)


# --------------------------------------------------------------------------- the counters

# the ops whose operands and results stream device memory (an elementwise
# chain fuses into them); matched on the op's name
_HBM_OPS = ("mm", "addmm", "bmm", "baddbmm", "addbmm", "dot", "vdot", "mv", "addmv",
            "convolution", "convolution_backward", "_scaled_dot_product_flash_attention",
            "_scaled_dot_product_efficient_attention", "_scaled_dot_product_cudnn_attention",
            "_flash_attention_forward", "_efficient_attention_forward",
            "_scaled_dot_product_flash_attention_backward",
            "_scaled_dot_product_efficient_attention_backward",
            "_scaled_dot_product_cudnn_attention_backward", "_flash_attention_backward",
            "_efficient_attention_backward",
            "embedding", "embedding_dense_backward", "gather", "index", "index_select",
            "take_along_dim", "scatter", "scatter_", "scatter_add", "scatter_add_",
            "scatter_reduce", "index_put", "index_put_", "_index_put_impl_", "index_add",
            "index_add_", "index_copy", "index_copy_", "slice_scatter", "select_scatter",
            "sort", "argsort", "topk", "sum", "mean", "amax", "amin", "max", "min", "argmax",
            "argmin", "prod", "var", "std", "var_mean", "logsumexp", "norm", "linalg_vector_norm",
            "cumsum", "_softmax", "_log_softmax", "_softmax_backward_data",
            "_log_softmax_backward_data", "nll_loss_forward", "nll_loss_backward", "any", "all")
_HBM_SET = frozenset(_HBM_OPS)

# collective op name -> the reference's kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced":
        "all-reduce", "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
        "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_tensor_coalesced_":
        "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}
_C10D = ("_c10d_functional", "c10d", "c10d_functional")


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Trace:
    """What ``Counters`` saw of one traced step (the counterpart of a
    compiled artifact's analyses).  Scaled regions count ``r`` times."""

    def __init__(self):
        self.flops = 0.0
        self.flops_fp32 = 0.0
        self.hbm_bytes = 0.0             # operands and results of the _HBM_OPS
        self.raw_bytes = 0.0
        self.coll: dict[str, float] = {}
        self.coll_cross = 0.0
        self.arg_bytes = 0
        self.out_bytes = 0
        self.peak_bytes = 0
        self.kernels: dict[str, dict] = {}   # planned kernel -> launches, flops, bytes
        self.scaled: dict[str, int] = {}     # what a scaled region stands for
        self.trace_s = 0.0

    def fused_bytes(self) -> float:
        """The bytes proxy: the _HBM_OPS' traffic, the kernels' and one read
        of the arguments and one write of the outputs."""
        return self.hbm_bytes + float(self.arg_bytes + self.out_bytes)


class Counters(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts a step's work a device (see the module docstring).

    Enter it OUTSIDE the plan's ``FakeTensorMode`` (``with Counters(fm), fm:``)
    so that DTensor's local ops reach it.  ``fake_mode`` set, only ops on
    that mode's tensors count; None counts every op (real tensors).
    ``resident(tensors)`` marks the step's arguments live from the start."""

    def __init__(self, fake_mode=None, *, node_size: int = 8):
        super().__init__()
        self.fake_mode = fake_mode
        self.node_size = node_size
        self.trace = Trace()
        self._live: dict[int, int] = {}
        self._now = 0
        self._ranks: dict = {}
        self._in_dtensor = False
        self._depth = 0

    # -- liveness
    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self._now -= n

    def _hold(self, t: torch.Tensor) -> int:
        """Mark ``t``'s storage live (once); returns its bytes if new, else 0."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self._now += n
        weakref.finalize(st, self._free, key, n)
        self.trace.peak_bytes = max(self.trace.peak_bytes, self._now)
        return n

    def resident(self, tree) -> int:
        """Mark the local tensors of ``tree`` (DTensors' blocks) live; returns
        their distinct storages' bytes, which are added to ``arg_bytes``."""
        n = sum(self._hold(t) for t in map(_local, _tensors(tree)))
        self.trace.arg_bytes += n
        return n

    def outputs(self, tree) -> None:
        """Count one write of the distinct storages of ``tree``'s local tensors."""
        seen = set()
        for t in map(_local, _tensors(tree)):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                self.trace.out_bytes += st.nbytes()

    # -- planned kernels (kernels.planned calls this for each planned launch)
    def kernel(self, name: str, flops: float, nbytes: float, scale: int) -> None:
        k = self.trace.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += scale
        k["flops"] += flops * scale
        k["bytes"] += nbytes * scale
        self.trace.flops += flops * scale
        self.trace.flops_fp32 += flops * scale
        self.trace.hbm_bytes += nbytes * scale
        self.trace.raw_bytes += nbytes * scale

    def __enter__(self):
        # re-entered inside its own dispatch (decompositions, DTensor's ops):
        # the outermost entry listens and times
        if self._depth == 0:
            self._t0 = time.perf_counter()
            self._listening = planned.listen(self)
            self._listening.__enter__()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth == 0:
            self._listening.__exit__(*exc)
            self.trace.trace_s += time.perf_counter() - self._t0
        return out

    # -- ops
    def _foreign(self, leaves) -> bool:
        """Whether an op's tensors are not the plan's: a meta tensor or another
        fake mode's (DTensor's sharding propagation), or, for its outputs, a
        real tensor (DTensor's index bookkeeping)."""
        if self.fake_mode is None:
            return False
        from torch._subclasses.fake_tensor import FakeTensor

        return any(t.is_meta or (isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode)
                   for t in leaves)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, DTensor) for t in ins):
            # DTensor runs it as local ops on its fake blocks, which reach this
            # mode and are counted.  Its own bookkeeping (index tensors it
            # reads on the host) runs with the fake mode off.
            if self._in_dtensor:
                return NotImplemented
            from torch._subclasses.fake_tensor import unset_fake_temporarily

            self._in_dtensor = True
            try:
                with unset_fake_temporarily(), self:
                    return func(*args, **kwargs)
            finally:
                self._in_dtensor = False
        if self._foreign(ins):
            return func(*args, **kwargs)     # DTensor's sharding propagation
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:                       # as FlopCounterMode: count what it decomposes to
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if self._foreign(outs) or (self.fake_mode is not None and not all(
                isinstance(t, FakeTensor) for t in outs)):
            return out
        scale = planned.scale()
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out)) * scale
            self.trace.flops += f
            if ins and ins[0].dtype in (torch.float32, torch.float64):
                self.trace.flops_fp32 += f
        moved = float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))) * scale
        self.trace.raw_bytes += moved
        name = func.__name__.split(".")[0]
        if func.namespace in _C10D:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                n = float(sum(map(_nbytes, outs))) * scale
                self.trace.coll[kind] = self.trace.coll.get(kind, 0.0) + n
                if self._cross_node(args):
                    self.trace.coll_cross += n
        elif name in _HBM_SET:
            self.trace.hbm_bytes += moved
        for t in outs:
            self._hold(t)
        return out

    def _cross_node(self, args) -> bool:
        """Whether a collective's group spans more than one node."""
        import torch.distributed as dist

        # the functional ops take the group's name last (after a reduce op's
        # name), the c10d ops a ProcessGroup
        group = next((a for a in reversed(args) if isinstance(a, str)
                      or type(a).__name__ in ("ProcessGroup", "ScriptObject")), None)
        if group is None:
            return True
        key = group if isinstance(group, str) else id(group)
        if key not in self._ranks:
            try:
                pg = (dist.distributed_c10d._resolve_process_group(group)
                      if isinstance(group, str) else group)
                ranks = dist.get_process_group_ranks(pg)
            except Exception:                # noqa: BLE001 -- an unknown group spans nodes
                ranks = [0, self.node_size]
            self._ranks[key] = len({r // self.node_size for r in ranks}) > 1
        return self._ranks[key]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's block (read without an op, which the counters would see)."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


# --------------------------------------------------------------------------- kernel work


def bound_s(work, spec: DeviceSpec = H100) -> tuple[float, str]:
    """The least seconds the card takes for ``(bytes, operations)`` and what
    bounds it: ``"bytes"`` at HBM's rate or ``"operations"`` at the fp32 rate."""
    t_bytes, t_ops = work[0] / spec.hbm_bw, work[1] / spec.fp32_flops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
