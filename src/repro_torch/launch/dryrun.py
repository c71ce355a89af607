"""Multi-pod dry run of the port: trace every (arch × shape × mesh) cell
on shapes alone.

Copy of ``repro/launch/dryrun.py`` in PyTorch's idiom.  For each cell:

  1. start a ``"fake"`` process group of the mesh's size (one process,
     no other rank, no wire) and build the production mesh on it (16×16
     single-pod / 2×16×16 multi-pod), on the ``"cpu"`` device type even
     where CUDA is present;
  2. resolve the parameters', optimizer state's and inputs' shardings
     from the logical rules, as JAX's ``lower_cell`` does, and place
     tensors of those shapes under ``FakeTensorMode`` (nothing is
     allocated, nothing is computed);
  3. run the step (``build_train_step`` / ``build_prefill_step`` /
     ``build_decode_step``) once on them, under :func:`collective_bytes`,
     :func:`track_memory` and ``FlopCounterMode``: the program's own
     DTensor sharding runs its collectives, and :func:`collective_bytes`
     reads each one's bytes, also those DTensor runs inside an
     operation's dispatch; :func:`track_memory` counts a device's live
     bytes;
  4. take compute and memory traffic from the analytic terms
     (:mod:`repro_torch.launch.roofline_model`) and write the cell's JSON
     under ``--out`` (``dryrun_torch_out/`` by default).

This is the counterpart of JAX's "lower, compile, and read the
collectives out of the HLO": there is no HLO, so no HLO parser; the trace
runs the collectives and :func:`collective_bytes` counts them as they are
run, loops and all.  The dry run is the one entry point of the port
that uses no device: it computes nothing (``"device": "fake"`` in its
result), as JAX's runs on forced host devices.

Three choices of the trace, each made here and nowhere in the models:

- **all-to-all on a CPU mesh.**  DTensor moves a shard from one tensor
  dim to another with an all-to-all over NCCL, but with an all-gather
  and a slice on a ``"cpu"`` mesh (gloo has no all-to-all).  The trace
  takes the all-to-all (:func:`_nccl_shard_moves`), so its bytes are
  those a run on the cards would move.
- **The MoE's data-dependent split.**  The expert-parallel bodies pack
  tokens into fixed-capacity slots whose sizes are Python ints
  (``models/moe.py``, ``cap = max(8, ...)``), so the all-to-all's bytes
  and the argument bytes do not depend on the routing; only the split of
  the received rows over the local experts does, and a fake tensor has
  no values to split by.  Inside the dry run the grouped GEMM's row
  counts are a balanced split of those rows over the local experts, and
  the fallback's (``_routed_sum``) a balanced split of the assignments
  over all experts: :func:`balanced_experts` replaces the two helpers
  that count them, nothing else.  This moves the traced FLOPs only.  MoE
  cells are never skipped.
- **Depth and sequence probes.**  Tracing llama3-405b's 126 layers, or
  xLSTM's per-token loops over 4096 tokens, would take hours.  Every
  count is affine in the number of scanned superblocks, so
  :func:`extrapolated_costs` traces JAX's probes at ``n_prefix + 2·pat``
  and ``+ 3·pat`` layers (``_scan_layout``; a model of at most two
  superblocks is traced whole).  xLSTM's train and prefill traces are
  per-token loops on DTensors whose every step runs the same
  collectives, so those cells are also probed at :data:`SEQ_PROBES`
  tokens and extrapolated to the cell's length (``"extrapolated":
  true``).  Jamba's Mamba scan runs on local shards inside a kernel's
  ``local_call``, where nothing crosses a wire: the dry run replaces its
  per-token loop by one pass of the same shapes and products
  (:func:`_scan_unrolled`) and traces Jamba at full length.

``traced_flops`` stands in for ``xla_cost["flops"]``: ``FlopCounterMode``
over the same trace, with DTensor operations counted once at their global
shapes (the logical computation) and the operations on plain tensors (the
kernels' bodies under ``local_call``, their backward, the MoE dispatch)
counted on this rank's shards and multiplied by the mesh's size, since
every rank runs them.

The memory fields stand in for JAX's ``xla_*`` ones, read off the same
trace by :class:`MemoryTracker` (hooked where the collectives are
counted): ``traced_argument_bytes`` (equal to
``analytic_arg_bytes_per_dev``), ``traced_output_bytes``,
``traced_peak_bytes`` and ``traced_temp_bytes``, and ``traced_cost``
(``bytes accessed``, ``transcendentals``) for ``xla_cost``'s.  They are
rank 0's, as the trace is, and eager PyTorch's live bytes, not XLA's
buffer assignment.  Inside the trace every ``ops`` entry point is counted
as its kernel (:func:`as_kernels`): the plain versions a CPU runs hold
what the card's kernels never do (attention's S x S scores).

Hardware constants, one NVIDIA H100 80GB HBM3 (SXM, power limit 700 W),
from its data sheet: :data:`PEAK_FLOPS`, :data:`HBM_BW` (the one copy is
``repro_torch.core.calibration.H100_HBM_BW``) and :data:`LINK_BW`, NVLink 4
per direction.  ``chip_smoke.py`` reads the first two from here.  A 16×16
mesh spans 32 eight-GPU nodes, whose links between nodes are slower than
NVLink; the collective term prices every byte at NVLink's rate.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
      --shape train_4k [--multi-pod] [--all] [--list] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..core.calibration import H100_HBM_BW
from ..distributed import sharding as shd
from ..distributed.optimizer import OptConfig, init_opt_state, state_shardings
from ..models import moe as M
from ..models import transformer as T
from ..models import zoo
from ..models.config import ModelConfig, ShapeConfig
from . import roofline_model as RM
from .mesh import make_mesh

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "dryrun_torch_out"

# NVIDIA H100 80GB HBM3 (SXM, 700 W power limit), per card, data sheet
PEAK_FLOPS = 989e12        # bf16 dense, no sparsity
HBM_BW = H100_HBM_BW       # 3.35e12 bytes/s
LINK_BW = 450e9            # NVLink 4, bytes/s per direction

#: the token counts of the sequence probes of the recurrent families
SEQ_PROBES = (16, 32)
RECURRENT_FAMILIES = ("ssm",)

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# op name (namespace.name) -> JAX's kind; the in-place ``c10d`` ops (their
# output is their first argument) end in ``_``
_KIND_OF = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    # point to point, and the root's sends of a scatter or a broadcast (a
    # cache made inside prefill is placed from rank 0's values)
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
    "c10d.scatter_": "collective-permute",
    "c10d.broadcast_": "collective-permute",
    "_c10d_functional.broadcast": "collective-permute",
    "_c10d_functional.broadcast_": "collective-permute",
}
# ops of those namespaces that move nothing
_NOT_COLLECTIVES = ("_c10d_functional.wait_tensor", "c10d.barrier", "c10d.monitored_barrier_")


# ---------------------------------------------------------------------------
# Collective bytes, read off the trace
# ---------------------------------------------------------------------------
def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _group_size(args) -> Optional[int]:
    """The size of the process group a collective's arguments name (a
    group name, or a ``ProcessGroup`` boxed as a ``ScriptObject``),
    ``None`` where none is found."""
    import torch.distributed as dist

    for a in args:
        try:
            if isinstance(a, str):
                return dist.distributed_c10d._resolve_process_group(a).size()
            if isinstance(a, torch.ScriptObject):
                return dist.ProcessGroup.unbox(a).size()
        except (AttributeError, KeyError, ValueError, RuntimeError, TypeError):
            continue
    return None


def _count(acc: Dict[str, int], func, args, out) -> None:
    """Adds ``func``'s bytes to ``acc`` where it is a collective."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d", "_dtensor"):
        return
    name = f"{ns}.{func._schema.name.split('::')[-1]}"
    if name in _NOT_COLLECTIVES or (ns == "_dtensor" and name not in _KIND_OF):
        return
    if name not in _KIND_OF:
        raise NotImplementedError(f"collective {name} has no kind in the dry run")
    if _group_size(args) == 1:
        return                   # a group of one rank moves nothing
    moved = args[0] if ns == "c10d" else out
    acc[_KIND_OF[name]] += sum(t.numel() * t.element_size() for t in _tensors(moved))
    acc["count"] += 1


@contextlib.contextmanager
def collective_bytes():
    """Sums the output bytes of every collective run on fake tensors
    inside the block, per JAX's five kinds, beside their ``count``; yields
    that dict.  An in-place ``c10d`` collective's output is its first
    argument; ``wait_tensor`` moves nothing and is not counted, nor is a
    collective over a group of one rank.  Bytes are per device (each
    rank's output), as the HLO parser's are.

    The block wraps ``FakeTensorMode.dispatch``, which every operation on
    a fake tensor reaches.  A Python dispatch mode would not do: DTensor
    runs the redistributions an operation needs (a ``Partial`` reduced
    before a nonlinear op, a gather before a view) inside its own
    dispatch, where no mode is on the stack, so a mode sees only the
    explicit ones, and which of them depends on the torch version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    acc = {k: 0 for k in _COLL_KINDS}
    acc["count"] = 0
    orig = FakeTensorMode.dispatch

    def dispatch(self, func, types, args=(), kwargs=None):
        out = orig(self, func, types, args, kwargs or {})
        _count(acc, func, args, out)
        return out

    FakeTensorMode.dispatch = dispatch
    try:
        yield acc
    finally:
        FakeTensorMode.dispatch = orig


@contextlib.contextmanager
def _nccl_shard_moves():
    """DTensor's shard-to-shard move as NCCL runs it (an all-to-all), also
    on a ``"cpu"`` mesh, where DTensor falls back to an all-gather: every
    module of ``torch.distributed.tensor`` that holds DTensor's
    ``shard_dim_alltoall`` gets one that calls the all-to-all op."""
    from torch.distributed.tensor import _collective_utils as cu

    orig = cu.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("torch.distributed.tensor")
            and getattr(m, "shard_dim_alltoall", None) is orig]
    for m in mods:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m in mods:
            m.shard_dim_alltoall = orig


@contextlib.contextmanager
def _real_index_math():
    """DTensor reckons a strided shard's sizes and offsets with small
    ``arange`` tensors whose values it reads; under ``FakeTensorMode``
    those have none, so inside this block that reckoning runs on real
    tensors (the placements' index math, not the model's data)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt

    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def real(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)

    cls.local_shard_size_and_offset = real
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


# ---------------------------------------------------------------------------
# Memory: a device's live bytes, read off the trace
# ---------------------------------------------------------------------------
#: operations (aten names, overload dropped) whose output elements count as
#: transcendentals, as XLA's cost analysis counts exp, log, tanh, ...
_TRANSCENDENTAL = frozenset({
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2", "log10", "tanh",
    "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "erf", "erfc",
    "erfinv", "pow", "pow_", "sin", "cos", "silu", "silu_", "gelu", "softplus",
    "_softmax", "_log_softmax", "logsumexp", "silu_backward", "gelu_backward",
})
#: operations that allocate without reading or writing a value
_NO_ACCESS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _extent(t: torch.Tensor) -> int:
    """The bytes of storage ``t`` reaches: a fresh output's allocation on
    a device (a fake collective's storage may be rounded up past it)."""
    if t.numel() == 0:
        return 0
    last = t.storage_offset() + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return (last + 1) * t.element_size()


class MemoryTracker:
    """One device's live bytes over a traced step, and what its
    operations touch: the counterpart of XLA's ``memory_analysis`` and of
    ``cost_analysis``'s ``bytes accessed`` / ``transcendentals``.

    Each storage an operation outputs is counted, at the bytes that output
    reaches (:func:`_extent`), from its making until it is freed
    (``weakref.finalize`` on the storage, whose Python object lives
    exactly as long as the storage does); a view or
    an in-place result shares a counted storage and adds nothing.  This is
    eager PyTorch's live bytes, not XLA's buffer assignment: a tensor
    lives while Python or autograd holds it.  ``peak`` is the most bytes
    live at once, and ``peaks`` the most in each phase of the step
    (:meth:`phase`).  ``accessed`` sums each operation's inputs and outputs
    (views, bare allocations and ``prim`` metadata queries move nothing
    and are left out),
    ``transcendentals`` the output elements of :data:`_TRANSCENDENTAL`
    operations.  Inside :meth:`paused` nothing is counted but, with
    ``work``, the transcendentals (:func:`as_kernels` runs the plain
    versions there for their values and FLOPs)."""

    def __init__(self) -> None:
        self.live = self.peak = self.accessed = self.transcendentals = 0
        self.peaks: Dict[str, int] = {}
        self._phase = "step"
        self._tracked: set = set()
        self._paused = 0
        self._work = True

    @contextlib.contextmanager
    def phase(self, name: str):
        """Inside, the live bytes count toward ``peaks[name]``."""
        prev, self._phase = self._phase, name
        self.peaks[name] = max(self.peaks.get(name, 0), self.live)
        try:
            yield
        finally:
            self._phase = prev

    def track(self, t) -> int:
        """Counts ``t``'s storage live from now (once); returns the bytes
        added."""
        if not isinstance(t, torch.Tensor) or shd.is_dtensor(t):
            return 0
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return 0
        key = id(st)
        if key in self._tracked:
            return 0
        n = _extent(t)
        self._tracked.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        self.peaks[self._phase] = max(self.peaks.get(self._phase, 0), self.live)
        weakref.finalize(st, self._free, key, n)
        return n

    def _free(self, key: int, n: int) -> None:
        self._tracked.discard(key)
        self.live -= n

    def track_tree(self, tree) -> int:
        """Counts every tensor of ``tree`` (dicts, tuples, lists; a
        DTensor's local shard); returns the bytes added."""
        if isinstance(tree, dict):
            return sum(self.track_tree(v) for v in tree.values())
        if isinstance(tree, (tuple, list)):
            return sum(self.track_tree(v) for v in tree)
        if shd.is_dtensor(tree):
            return self.track(tree._local_tensor)
        return self.track(tree)

    def observe(self, func, args, kwargs, out) -> None:
        """One operation: its outputs' storages, its bytes and transcendentals."""
        if self._paused and not self._work:
            return
        from torch.utils._pytree import tree_leaves

        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func._schema.name.split("::")[-1]
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if self._paused:
            return
        for t in outs:
            self.track(t)
        if not func.is_view and name not in _NO_ACCESS and func.namespace != "prim":
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.accessed += sum(_nbytes(t) for t in ins + outs)

    @contextlib.contextmanager
    def paused(self, work: bool = True):
        prev = self._work
        self._paused += 1
        self._work = prev and work
        try:
            yield
        finally:
            self._paused -= 1
            self._work = prev


@contextlib.contextmanager
def track_memory(tracker: Optional[MemoryTracker] = None, real: bool = False):
    """Counts into ``tracker`` (a new :class:`MemoryTracker` by default)
    every operation on fake tensors inside the block, at
    ``FakeTensorMode.dispatch`` as :func:`collective_bytes` counts (so also
    the temporaries DTensor makes inside its own dispatch; of an operation
    the fake mode decomposes, the operation and not its parts, as a device
    runs it); yields the tracker.  With ``real``, every operation on real plain tensors
    instead, through a dispatch mode (DTensor's own operations pass no
    mode, so not for DTensors)."""
    tracker = tracker if tracker is not None else MemoryTracker()
    if real:
        from torch.utils._python_dispatch import TorchDispatchMode

        class _Observe(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                tracker.observe(func, args, kwargs, out)
                return out

        with _Observe():
            yield tracker
        return
    from torch._subclasses.fake_tensor import FakeTensorMode

    orig = FakeTensorMode.dispatch
    depth = [0]

    def dispatch(self, func, types, args=(), kwargs=None):
        # an operation the fake mode decomposes dispatches its parts here
        # too, but only where its cache misses: only the outermost counts
        depth[0] += 1
        try:
            out = orig(self, func, types, args, kwargs or {})
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            tracker.observe(func, args, kwargs, out)
        return out

    FakeTensorMode.dispatch = dispatch
    try:
        with _unseen_meta_propagation(tracker):
            yield tracker
    finally:
        FakeTensorMode.dispatch = orig


@contextlib.contextmanager
def _unseen_meta_propagation(tracker: MemoryTracker):
    """DTensor works out an operation's output shape by running it on
    global-shaped fake tensors in the active fake mode (its sharding
    propagation): no device allocates those, so ``tracker`` is paused
    there."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator as SP

    names = [n for n in ("propagate_op_sharding_non_cached",
                         "_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
             if hasattr(SP, n)]
    orig = {n: getattr(SP, n) for n in names}

    def paused(fn):
        def call(*args, **kwargs):
            with tracker.paused(work=False):
                return fn(*args, **kwargs)

        return call

    for n in names:
        setattr(SP, n, paused(orig[n]))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(SP, n, fn)


# ---------------------------------------------------------------------------
# The kernels' memory (dry run only)
# ---------------------------------------------------------------------------
#: CTAs of the RMSNorm backward kernel on one H100 (132 SMs, at most two
#: CTAs a SM): its f32 dgamma scratch is one row a CTA
_RMSNORM_BWD_CTAS = 2 * 132


@contextlib.contextmanager
def _flops_uncounted(counter):
    """FlopCounterMode ``counter``'s counts as they were before the block."""
    if counter is None:
        yield
        return
    saved = {k: dict(v) for k, v in counter.flop_counts.items()}
    try:
        yield
    finally:
        counter.flop_counts.clear()
        for k, v in saved.items():
            counter.flop_counts[k].update(v)


@contextlib.contextmanager
def as_kernels(tracker: MemoryTracker, flops=None):
    """Inside: every ``ops`` entry point takes the kernel route (its
    autograd Function under grad, which saves what the card's saves: flash
    attention's q, k, v, output and LSE, RMSNorm's x and gamma, the scan's
    inputs and its 32-step checkpoints), and each kernel wrapper is counted
    as its kernel: its outputs, and the workspace its wrapper allocates
    (the flash backward's ``delta``, RMSNorm backward's dgamma rows, the
    scan backward's partials).  Its values come from the plain version,
    run with ``tracker`` paused, so the S x S scores of plain attention or
    the (B, T, D, N) states of :func:`_scan_at_once` are never counted
    live.  FLOPs do not move: a forward wrapper runs the plain forward
    once; a backward wrapper runs the plain forward again with ``flops``
    (a FlopCounterMode) restored after it, then autograd's backward of it,
    counted as the plain route's backward is."""
    from ..kernels import _build, ops
    from ..kernels import ref as R

    f32 = torch.float32

    def plain(fn, *args, **kwargs):
        with tracker.paused(), torch.no_grad():
            return fn(*args, **kwargs)

    def made(inputs, *outs, workspace=()):
        """Fresh copies of ``outs`` (the kernel writes fresh tensors),
        counted live, and ``workspace`` (shape, dtype) counted while the
        call runs."""
        with tracker.paused():
            fresh = [o.clone() for o in outs]
            dev = fresh[0].device
            ws = [torch.empty(shape, dtype=dt, device=dev) for shape, dt in workspace]
        for t in fresh + ws:
            tracker.track(t)
        tracker.accessed += (sum(_nbytes(t) for t in inputs if t is not None)
                             + sum(_nbytes(t) for t in fresh) + 2 * sum(_nbytes(t) for t in ws))
        return fresh

    def grads(fn, inputs, grad_outs):
        """The plain version's gradients at ``inputs`` for ``grad_outs``
        (``None`` where an output's gradient is)."""
        leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
        with tracker.paused(work=False), _flops_uncounted(flops), torch.enable_grad():
            outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outs) if g is not None]
        with tracker.paused():
            got = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs],
                                      allow_unused=True)
        return [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, got)]

    def fa(q, k, v, causal=True, scale=None, q_offset=0, kv_len=None, return_lse=False):
        out = plain(R.attention_ref, q, k, v, causal=causal, scale=scale,
                    q_offset=q_offset, kv_len=kv_len)
        B, Sq, H, _ = q.shape
        if not return_lse:
            return made((q, k, v), out)[0]
        with tracker.paused():
            lse = torch.empty((B, H, Sq), dtype=f32, device=q.device)
        return tuple(made((q, k, v), out, lse))

    def fab(q, k, v, o, lse, do, causal=True, scale=None):
        g = grads(lambda q, k, v: R.attention_ref(q, k, v, causal=causal, scale=scale),
                  (q, k, v), (do,))
        B, Sq, H, _ = q.shape
        return tuple(made((q, k, v, o, lse, do), *g, workspace=[((B, H, Sq), f32)]))

    def rn(x, gamma, eps=1e-5):
        return made((x, gamma), plain(R.rmsnorm_ref, x, gamma, eps=eps))[0]

    def rnb(x, gamma, dy, eps=1e-5):
        g = grads(lambda x, gm: R.rmsnorm_ref(x, gm, eps=eps), (x, gamma), (dy,))
        rows, d = x.numel() // max(1, x.shape[-1]), x.shape[-1]
        return tuple(made((x, gamma, dy), *g,
                          workspace=[((min(rows, _RMSNORM_BWD_CTAS), d), f32)]))

    def ss(x, dt, A, Bm, Cm, D, h0=None, return_states=False):
        y, hT = plain(R.ssm_scan_ref, x, dt, A, Bm, Cm, D, h0=h0)
        B, T, Dd = x.shape
        if not return_states:
            return tuple(made((x, dt, A, Bm, Cm, D, h0), y, hT))
        with tracker.paused():
            states = torch.empty((B, _build.ssm_checkpoints(T), Dd, A.shape[1]), dtype=f32,
                                 device=x.device)
        return tuple(made((x, dt, A, Bm, Cm, D, h0), y, hT, states))

    def ssb(x, dt, A, Bm, Cm, D, states, dy, h0=None, dhT=None):
        ins = (x, dt, A, Bm, Cm, D) + (() if h0 is None else (h0,))
        g = grads(lambda *a: R.ssm_scan_ref(*a[:6], h0=a[6] if len(a) > 6 else None),
                  ins, (dy, dhT))
        B, T, Dd = x.shape
        N = A.shape[1]
        n_blk = -(-Dd // _build.SSM_CHANNELS_PER_CTA)
        out = made((*ins, states, dy, dhT), *g,
                   workspace=[((2, n_blk, B, T, N), f32), ((B, Dd, N), f32), ((B, Dd), f32)])
        return (*out[:6], out[6] if h0 is not None else None)

    def da(q, k_cache, v_cache, lengths, scale=None):
        out = plain(R.decode_attention_ref, q, k_cache, v_cache, lengths, scale=scale)
        return made((q, k_cache, v_cache, lengths), out)[0]

    def paged(fn, int8):
        def call(q, kp, vp, table, pos, *scales, scale=None):
            kw = dict(k_scales=scales[0], v_scales=scales[1]) if int8 else {}
            out = plain(fn, q, kp, vp, table, pos, scale=scale, **kw)
            return made((q, kp, vp, table, pos if torch.is_tensor(pos) else None, *scales),
                        out)[0]

        return call

    patched = {"_use_kernel": lambda impl, x: impl != "ref", "_fa": fa, "_fab": fab,
               "_rn": rn, "_rnb": rnb, "_ss": ss, "_ssb": ssb, "_da": da,
               "_pda": paged(R.paged_decode_attention_ref, False),
               "_pda8": paged(R.paged_decode_attention_ref, True),
               "_ppa": paged(R.paged_prefill_attention_ref, False),
               "_ppa8": paged(R.paged_prefill_attention_ref, True)}
    orig = {name: getattr(ops, name) for name in patched}
    for name, fn in patched.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(ops, name, fn)


# ---------------------------------------------------------------------------
# The MoE's balanced split (dry run only)
# ---------------------------------------------------------------------------
def _balanced(n: int, parts: int) -> List[int]:
    return [n // parts + (e < n % parts) for e in range(parts)]


@contextlib.contextmanager
def balanced_experts(cfg: ModelConfig):
    """Inside: the expert-parallel bodies' grouped GEMM splits its rows
    evenly over the local experts (``moe._group_counts``), and the
    fallback (``moe._routed_sum``) gives each of the ``n_experts`` experts
    an even share of the assignments (``moe._expert_counts``).  Only those
    two count helpers change: the products, shapes and collectives are
    the models' own."""
    group_counts, expert_counts = M._group_counts, M._expert_counts
    n_experts = cfg.moe.n_experts if cfg.moe is not None else 1

    def group(eid, E_l):
        return _balanced(eid.shape[0], E_l)

    def expert(flat, E_l, e0):
        every = _balanced(flat.numel(), n_experts)
        lo = e0 or 0
        return sum(every[:lo]), every[lo:lo + E_l]

    M._group_counts, M._expert_counts = group, expert
    try:
        yield
    finally:
        M._group_counts, M._expert_counts = group_counts, expert_counts


# ---------------------------------------------------------------------------
# The selective scan without its loop (dry run only)
# ---------------------------------------------------------------------------
def _scan_at_once(x, dt, A, Bm, Cm, D, h0=None):
    """``ref.ssm_scan_ref``'s outputs, shapes and products in one pass
    over T in place of a step a token: ``h_t = exp(a_t) (h_0 + sum_{s<=t}
    exp(-a_s) dBx_s)`` with ``a_t`` the running sum of ``dt·A``, and ``y``
    one ``einsum`` of the same FLOPs as the loop's.  Overflows on long
    real inputs; the dry run computes nothing."""
    xf, dtf = x.float(), dt.float()
    a = torch.cumsum(dtf[..., None] * A.float(), dim=1)          # (B, T, D, N)
    dBx = (dtf * xf)[..., None] * Bm.float()[:, :, None, :]
    acc = torch.cumsum(torch.exp(-a) * dBx, dim=1)
    if h0 is not None:
        acc = acc + h0.float()[:, None]
    h = torch.exp(a) * acc
    y = torch.einsum("btdn,btn->btd", h, Cm.float()) + xf * D.float()[None, None, :]
    return y.to(x.dtype), h[:, -1]


@contextlib.contextmanager
def _scan_unrolled():
    """The plain selective scan as :func:`_scan_at_once`: it runs inside a
    kernel's ``local_call`` body, where nothing crosses a wire, so the
    collectives are those of the loop; the trace no longer grows with a
    Mamba layer's length."""
    from ..kernels import ref

    orig = ref.ssm_scan_ref
    ref.ssm_scan_ref = _scan_at_once
    try:
        yield
    finally:
        ref.ssm_scan_ref = orig


# ---------------------------------------------------------------------------
# Traced FLOPs
# ---------------------------------------------------------------------------
def _flop_counter(n_chips: int):
    """``FlopCounterMode`` whose formulas count an operation on plain
    tensors (a rank's shards) ``n_chips`` times, one on DTensors once."""
    from torch.utils.flop_counter import FlopCounterMode, flop_registry

    def scaled(formula):
        def count(*args, out_val=None, **kwargs):
            n = formula(*args, out_val=out_val, **kwargs)
            local = not any(shd.is_dtensor(t) for t in _tensors(list(args)))
            return n * n_chips if local else n

        count._get_raw = True
        return count

    return FlopCounterMode(display=False,
                           custom_mapping={k: scaled(f) for k, f in flop_registry.items()})


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------
def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _zip_leaves(shapes, shardings) -> Iterator[Tuple[torch.Tensor, Any]]:
    """(tensor, sharding) pairs, walking the tensor tree's structure."""
    if isinstance(shapes, dict):
        for k, v in shapes.items():
            yield from _zip_leaves(v, shardings[k])
    elif isinstance(shapes, (tuple, list)):
        for i, v in enumerate(shapes):
            yield from _zip_leaves(v, shardings[i])
    else:
        yield shapes, shardings


def _tree_bytes_per_dev(mesh, tree_shapes, tree_shardings) -> int:
    """Analytic per-device bytes of a sharded tree (weights/opt/cache):
    each leaf's bytes floor-divided by the sizes of the mesh dims that
    shard it, as JAX's.  ``mesh`` is a DeviceMesh or any object with
    ``mesh_dim_names`` and ``shape``; a ``None`` sharding is replicated."""
    from torch.distributed.tensor import Shard

    sizes = shd.mesh_shape(mesh)
    names = list(mesh.mesh_dim_names)
    total = 0
    for t, sh in _zip_leaves(tree_shapes, tree_shardings):
        nbytes = t.numel() * t.element_size()
        frac = 1
        if sh is not None:
            for m, pl in enumerate(sh.placements):
                if isinstance(pl, Shard):
                    frac *= sizes[names[m]]
        total += nbytes // max(1, frac)
    return total


def _cell_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh, opt_state_dtype: str):
    """(param shapes, param shardings, input metas, input shardings,
    opt-state shapes or None, opt-state shardings or None) of one cell
    under the active mesh and rules."""
    model_axis = shd.mesh_shape(mesh).get("model", 1)
    specs_in = zoo.input_specs(cfg, shape)
    logical_in = zoo.input_logical(cfg, shape)
    if "cache" in specs_in:
        logical_in["cache"] = zoo.cache_logical(cfg, specs_in["cache"], model_axis)
    p_shapes, p_specs = zoo.param_shapes(cfg)
    param_sh = shd.tree_shardings(p_specs, p_shapes, mesh)
    batch_sh = shd.tree_shardings(logical_in, specs_in, mesh)
    o_shapes = o_sh = None
    if shape.kind == "train":
        o_shapes = zoo.opt_state_shapes(cfg, OptConfig(state_dtype=opt_state_dtype), p_shapes)
        o_sh = state_shardings(param_sh, o_shapes)
    return p_shapes, param_sh, specs_in, batch_sh, o_shapes, o_sh


def _arg_bytes(mesh, p_shapes, param_sh, specs_in, batch_sh, o_shapes, o_sh) -> int:
    total = (_tree_bytes_per_dev(mesh, p_shapes, param_sh)
             + _tree_bytes_per_dev(mesh, specs_in, batch_sh))
    if o_shapes is not None:
        total += _tree_bytes_per_dev(mesh, o_shapes, o_sh)
    return total


def cell_arg_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   opt_state_dtype: str = "int8", rules=None) -> int:
    """Per-device bytes of the step's arguments: parameters, AdamW state
    (train) and inputs, as JAX's ``lower_cell`` reckons them.  Reads
    shapes only: ``mesh`` may be any object with ``mesh_dim_names`` and
    ``shape``."""
    with shd.use_mesh(mesh, rules=rules):
        return _arg_bytes(mesh, *_cell_shardings(cfg, shape, mesh, opt_state_dtype))


# ---------------------------------------------------------------------------
# The fake process group and the trace
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_mesh(shape: Tuple[int, ...]):
    """A ``"fake"`` process group of ``prod(shape)`` ranks (this process is
    rank 0; no other rank exists and nothing crosses a wire) and a
    ``"cpu"`` DeviceMesh of ``shape`` on it, its dims the last of
    ``("pod", "data", "model")``; destroyed on exit.  Raises where the
    process already has a default group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group, and this "
                           "process already has a default group")
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield make_mesh(tuple(shape), ("pod", "data", "model")[-len(shape):],
                        device_type="cpu")
    finally:
        dist.destroy_process_group()


def _fake(tree):
    """Tensors on the CPU in the shapes and dtypes of ``tree``'s, made
    under the active ``FakeTensorMode``."""
    return _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="cpu"), tree)


@contextlib.contextmanager
def _train_phases(tracker: MemoryTracker):
    """A train step's two phases for ``tracker``: ``grads`` (the forward
    and its backward, ``zoo.loss_and_grads``) and ``update`` (AdamW).  Each
    phase's peak is affine in depth where the step's is not: which phase
    peaks can change with depth (the update's largest leaf against the
    backward's activations)."""
    grads_fn, update_fn = zoo.loss_and_grads, zoo.adamw_update

    def in_phase(name, fn):
        def call(*args, **kwargs):
            with tracker.phase(name):
                return fn(*args, **kwargs)

        return call

    zoo.loss_and_grads = in_phase("grads", grads_fn)
    zoo.adamw_update = in_phase("update", update_fn)
    try:
        yield
    finally:
        zoo.loss_and_grads, zoo.adamw_update = grads_fn, update_fn


def _memory(argument: int, output: int, peaks: Dict[str, int]) -> Dict[str, Any]:
    peak = max([argument, *peaks.values()])
    return {"argument": argument, "output": output, "peak": peak, "temp": peak - argument,
            "phase_peaks": dict(peaks)}


def _placed_args(cfg: ModelConfig, shape: ShapeConfig, mesh, opt_state_dtype: str):
    """(the cell's step, its arguments placed on ``mesh``, analytic
    argument bytes a device), under the active ``FakeTensorMode`` and
    mesh."""
    shardings = _cell_shardings(cfg, shape, mesh, opt_state_dtype)
    p_shapes, param_sh, specs_in, batch_sh, _, _ = shardings
    params = shd.device_put_tree(_fake(p_shapes), param_sh)
    batch = shd.device_put_tree(_fake(specs_in), batch_sh)
    if shape.kind == "train":
        opt_cfg = OptConfig(state_dtype=opt_state_dtype)
        args = (params, init_opt_state(params, opt_cfg), batch)
        step = zoo.build_train_step(cfg, opt_cfg)
    elif shape.kind == "prefill":
        args = (params, batch)
        step = zoo.build_prefill_step(cfg, max_len=shape.seq_len + 8)
    else:
        args = (params, batch)
        step = zoo.build_decode_step(cfg)
    return step, args, _arg_bytes(mesh, *shardings)


def step_memory(step, make_args, fake: bool = True) -> Dict[str, Any]:
    """The memory fields and cost of ``step(*make_args())`` on one device
    without a mesh, as :func:`trace_cell` counts them (the kernel rule
    on): the arguments made
    under ``FakeTensorMode``, or with ``fake=False`` on real tensors of the
    CPU (a dispatch mode counts there)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() if fake else contextlib.nullcontext():
        args = make_args()
        tracker = MemoryTracker()
        arguments = tracker.track_tree(args)
        with track_memory(tracker, real=not fake), as_kernels(tracker), \
                _train_phases(tracker), tracker.phase("step"):
            out = step(*args)
        output = MemoryTracker().track_tree(out)
    return {"memory": _memory(arguments, output, tracker.peaks),
            "cost": {"bytes accessed": tracker.accessed,
                     "transcendentals": tracker.transcendentals}}


def placed_arg_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     opt_state_dtype: str = "int8", rules=None) -> int:
    """The bytes this rank holds of the cell's placed arguments
    (``traced_argument_bytes``): the local shards' storages, placed as
    :func:`trace_cell` places them, without running the step."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), shd.use_mesh(mesh, rules=rules), _real_index_math():
        _, args, _ = _placed_args(cfg, shape, mesh, opt_state_dtype)
        return MemoryTracker().track_tree(args)


def trace_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    opt_state_dtype: str = "int8",
    rules=None,
    kernels: bool = True,
) -> Tuple[Dict[str, int], Dict[str, Any]]:
    """Run one cell's step on fake tensors placed on ``mesh``: returns
    (its collectives, as :func:`collective_bytes` counts them, and
    ``{"arg_bytes_per_dev", "flops", "memory", "cost"}``).  The
    counterpart of JAX's ``lower_cell``; ``mesh`` is a DeviceMesh on a
    fake group (:func:`fake_mesh`).

    ``memory`` is rank 0's, as the trace is (a rank with another shard of
    an uneven split holds other sizes): ``argument`` bytes (the placed
    parameters, optimizer state, batch and cache), ``output`` bytes (what
    the step returns), ``peak`` (the most bytes live at once, the
    arguments included), ``temp`` (the peak less the arguments) and
    ``phase_peaks`` (the peak of each phase, :func:`_train_phases`);
    ``cost`` holds ``bytes accessed`` and ``transcendentals``
    (:class:`MemoryTracker`).  With ``kernels`` every ``ops`` entry point
    is counted as its kernel (:func:`as_kernels`); the FLOPs are the same
    either way."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    n_chips = mesh.size()
    with FakeTensorMode(), shd.use_mesh(mesh, rules=rules), _real_index_math():
        step, args, arg_bytes = _placed_args(cfg, shape, mesh, opt_state_dtype)
        tracker = MemoryTracker()
        arguments = tracker.track_tree(args)
        flops = _flop_counter(n_chips)
        rule = as_kernels(tracker, flops) if kernels else contextlib.nullcontext()
        with _nccl_shard_moves(), balanced_experts(cfg), _scan_unrolled(), flops, \
                collective_bytes() as coll, track_memory(tracker), rule, \
                _train_phases(tracker), tracker.phase("step"):
            out = step(*args)
        output = MemoryTracker().track_tree(out)
    memory = _memory(arguments, output, tracker.peaks)
    cost = {"bytes accessed": tracker.accessed, "transcendentals": tracker.transcendentals}
    return coll, {"arg_bytes_per_dev": arg_bytes, "flops": flops.get_total_flops(),
                  "memory": memory, "cost": cost}


def _cell_costs(cfg, shape, mesh, opt_state_dtype, rules=None,
                kernels: bool = True) -> Dict[str, Any]:
    """(traced flops, collective bytes, memory and cost) of one traced cell."""
    coll, aux = trace_cell(cfg, shape, mesh, opt_state_dtype=opt_state_dtype, rules=rules,
                           kernels=kernels)
    return {
        "flops": int(aux["flops"]),
        "coll": int(sum(v for k, v in coll.items() if k != "count")),
        "coll_by_kind": dict(coll),
        "memory": aux["memory"],
        "cost": aux["cost"],
    }


def _extend(x_a: Dict[str, Any], x_b: Dict[str, Any], steps: int, per: int) -> Dict[str, Any]:
    """``x_a + steps/per · max(0, x_b - x_a)`` of every count (nested
    dicts included), exact in integers (``per`` divides ``steps``).  The
    peak is the largest of the phases' peaks so extended: each phase's
    peak is assumed affine in depth and length, as the other counts are."""
    if steps % per:
        raise ValueError(f"a probe step of {per} does not divide {steps}")

    def one(a, b):
        if isinstance(a, dict):
            return {k: one(a[k], b[k]) for k in a}
        return a + (steps // per) * max(0, b - a)

    out = one(x_a, x_b)
    mem = out["memory"]
    out["memory"] = _memory(mem["argument"], mem["output"], mem["phase_peaks"])
    return out


def _seq_probed(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    return cfg.family in RECURRENT_FAMILIES and shape.kind in ("train", "prefill")


def _probe(args) -> Dict[str, Any]:
    """One probe in a process of its own (a worker of the pool): its own
    fake group and mesh."""
    cfg, shape, mesh_shape, opt_state_dtype, rules, kernels = args
    with fake_mesh(mesh_shape) as mesh:
        return _cell_costs(cfg, shape, mesh, opt_state_dtype, rules, kernels)


def extrapolated_costs(cfg, shape, mesh, opt_state_dtype, rules=None,
                       workers: int = 1, kernels: bool = True) -> Dict[str, Any]:
    """The cell's traced flops, collective bytes, memory and cost from
    short probes.

    Every count is affine in the number of scanned superblocks: trace
    depth probes at 2 and 3 superblocks and extrapolate exactly, as JAX's
    ``X(n) = X(2) + (n - 2)·(X(3) - X(2))``; a model of at most two
    superblocks is traced whole (JAX's rule for ``n_sb <= 2``).  In a
    recurrent family's train or prefill cell each depth is traced at
    :data:`SEQ_PROBES` tokens and extrapolated to the cell's length the
    same way, its collectives per token being constant.  ``probes`` lists
    the (layers, tokens) traced, ``per_superblock`` the collectives one
    more superblock adds (``None`` where the model was traced whole).
    With ``workers > 1`` the probes run in that many processes at once,
    each on a fake group of ``mesh``'s shape.
    """
    n_prefix, pat, n_sb = T._scan_layout(cfg)
    depths = [None] if n_sb <= 2 else [2, 3]
    seqs = list(SEQ_PROBES) if _seq_probed(cfg, shape) else [None]
    cells = {(d, s): (cfg if d is None else cfg.with_(n_layers=n_prefix + d * pat),
                      shape if s is None else dataclasses.replace(shape, seq_len=s))
             for d in depths for s in seqs}
    keys = list(cells)
    if workers > 1 and len(keys) > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        jobs = [(c, sh, tuple(mesh.shape), opt_state_dtype, rules, kernels)
                for c, sh in cells.values()]
        with cf.ProcessPoolExecutor(min(workers, len(jobs)),
                                    mp_context=mp.get_context("spawn")) as pool:
            got = dict(zip(keys, pool.map(_probe, jobs)))
    else:
        got = {k: _cell_costs(c, sh, mesh, opt_state_dtype, rules, kernels)
               for k, (c, sh) in cells.items()}
    probes = [[cells[k][0].n_layers, cells[k][1].seq_len] for k in keys]
    a, b = SEQ_PROBES
    rows = {d: got[d, None] if seqs == [None]
            else _extend(got[d, a], got[d, b], shape.seq_len - a, b - a)
            for d in depths}
    out = rows[None] if depths == [None] else _extend(rows[2], rows[3], n_sb - 2, 1)
    per_sb = None if depths == [None] else {
        k: v - rows[2]["coll_by_kind"][k] for k, v in rows[3]["coll_by_kind"].items()}
    out.update(extrapolated=len(keys) > 1, probes=probes, per_superblock=per_sb)
    return out


# Perf-iteration variants: config + sharding-rule overrides applied on top
# of the baseline (the JAX package's table).
VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    # pure data parallelism: replicate weights, batch over (data × model) —
    # the right layout for sub-4B models on a 256-chip mesh
    "dp": {
        "rules": {
            "heads": [None], "kv_heads": [None], "ff": [None],
            "vocab": [None], "embed": [None], "experts": [None],
            "heads_act": [None], "ff_act": [None], "vocab_act": [None],
            "batch": [("pod", "data", "model"), ("data", "model"), "data"],
        }
    },
    # sequence parallelism: residual stream sharded over model between
    # blocks (all-reduce -> reduce-scatter + all-gather)
    "sp": {"rules": {"seq_act": ["model", None]}},
    # int8 KV cache for decode (halves cache HBM traffic + residency)
    "int8kv": {"cfg": {"kv_cache_dtype": "int8"}},
    # MoE: bf16 expert-combine psum + capacity factor 1.0
    "moe_opt": {"moe": {"capacity_factor": 1.0, "combine_dtype": "bfloat16"}},
    # + int8 dispatch payload on top of moe_opt
    "moe_opt2": {"moe": {"capacity_factor": 1.0, "combine_dtype": "bfloat16",
                         "dispatch_dtype": "int8"}},
    # + deduplicated, group-limited (L=4) dispatch
    "moe_opt3": {"moe": {"capacity_factor": 1.0, "combine_dtype": "bfloat16",
                         "dispatch_dtype": "int8", "dedup_dispatch": True,
                         "shard_groups": 4}},
    # weight-stationary decode: replicate the (tiny) decode activations
    # over data so the weights are not gathered every step; + int8 KV
    "serve_opt": {
        "cfg": {"kv_cache_dtype": "int8"},
        "rules": {"dec_batch": [None]},
    },
    # + weight-stationary decode MLP
    "serve_opt2": {
        "cfg": {"kv_cache_dtype": "int8", "decode_mlp": "ws"},
        "rules": {"dec_batch": [None]},
    },
    "moe_opt_sp": {
        "moe": {"capacity_factor": 1.0, "combine_dtype": "bfloat16"},
        "rules": {"seq_act": ["model", None]},
    },
}


def apply_variant(cfg: ModelConfig, variant: str):
    v = VARIANTS[variant]
    if "cfg" in v:
        cfg = cfg.with_(**v["cfg"])
    if "moe" in v and cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **v["moe"]))
    return cfg, v.get("rules")


def _mesh_tag(mesh_shape: Tuple[int, ...]) -> str:
    return "x".join(str(s) for s in mesh_shape)


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    save: bool = True,
    opt_state_dtype: str = "int8",
    variant: str = "baseline",
    cfg_override: Optional[ModelConfig] = None,
    mesh_shape: Optional[Tuple[int, ...]] = None,
    out_dir: Optional[pathlib.Path] = None,
    workers: int = 1,
) -> Dict[str, Any]:
    """Trace one cell on a fake group of the mesh's size (16×16, 2×16×16
    with ``multi_pod``, or ``mesh_shape``) and return its record; saved as
    JSON under ``out_dir`` (:data:`OUT_DIR`) with ``save``.  ``workers``:
    processes tracing the probes at once (:func:`extrapolated_costs`)."""
    cfg = cfg_override or get_config(arch)
    cfg, rule_override = apply_variant(cfg, variant)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod else (16, 16)))
    with fake_mesh(mesh_shape) as mesh:
        n_chips = mesh.size()
        t0 = time.perf_counter()
        costs = extrapolated_costs(cfg, shape, mesh, opt_state_dtype, rule_override,
                                   workers=workers)
        t_trace = time.perf_counter() - t0
        arg_bytes = cell_arg_bytes(cfg, shape, mesh, opt_state_dtype, rule_override)

    # wire bytes: all-reduce moves ~2x its output (reduce-scatter +
    # all-gather phases); the others move ~1x output
    coll = costs["coll_by_kind"]
    coll_total = sum((2 * v if k == "all-reduce" else v)
                     for k, v in coll.items() if k != "count")

    flops = RM.analytic_flops(cfg, shape)
    bytes_hbm = RM.analytic_bytes(cfg, shape)

    total_p, active_p = cfg.param_count()
    if shape.kind == "train":
        tok = shape.global_batch * shape.seq_len
        model_flops = 6 * active_p * tok
    elif shape.kind == "prefill":
        tok = shape.global_batch * shape.seq_len
        model_flops = 2 * active_p * tok
    else:
        tok = shape.global_batch
        model_flops = 2 * active_p * tok

    result = {
        "arch": arch,
        "shape": shape_name,
        "variant": variant,
        "mesh": _mesh_tag(mesh_shape),
        "n_chips": int(n_chips),
        "kind": shape.kind,
        "device": "fake",
        "lower_s": round(t_trace, 1),
        "extrapolated": costs["extrapolated"],
        "probes": costs["probes"],
        "memory": {"analytic_arg_bytes_per_dev": int(arg_bytes),
                   **{f"traced_{k}_bytes": int(costs["memory"][k])
                      for k in ("argument", "output", "peak", "temp")},
                   "traced_phase_peak_bytes": costs["memory"]["phase_peaks"]},
        "analytic_flops": flops,
        "analytic_bytes": bytes_hbm,
        "traced_flops": costs["flops"],
        "traced_cost": {k: int(v) for k, v in costs["cost"].items()},
        "collectives": coll,
        "collectives_per_superblock": costs["per_superblock"],
        "collective_bytes": coll_total,
        "model_flops": model_flops,
        "roofline": roofline_terms(flops, bytes_hbm, coll_total, n_chips),
        "useful_flops_ratio": (model_flops / flops) if flops else None,
    }
    if save:
        out = pathlib.Path(out_dir or OUT_DIR)
        out.mkdir(parents=True, exist_ok=True)
        tag = f"{arch.replace('.', '_').replace('-', '_')}__{shape_name}__{result['mesh']}"
        if variant != "baseline":
            tag += f"__{variant}"
        with open(out / f"dryrun_{tag}.json", "w") as f:
            json.dump(result, f, indent=2)
    return result


def roofline_terms(flops, bytes_hbm, coll_bytes, n_chips) -> Dict[str, float]:
    """The three roofline terms in seconds on H100s.

    The analytic FLOPs and bytes are global, so compute and memory divide
    by the cards; the collective bytes are each rank's, so they divide
    only by one card's link rate."""
    return {
        "compute_s": flops / (n_chips * PEAK_FLOPS),
        "memory_s": bytes_hbm / (n_chips * HBM_BW),
        "collective_s": coll_bytes / LINK_BW,
    }


# ---------------------------------------------------------------------------
def iter_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            yield arch, sname, ok, why


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--opt-state", default="int8")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=None,
                    help=f"directory of the cells' JSON (default {OUT_DIR})")
    ap.add_argument("--workers", type=int, default=4,
                    help="processes tracing a cell's probes at once")
    ap.add_argument("--cells", default=None,
                    help="ARCH:SHAPE,... (in place of --arch/--shape)")
    args = ap.parse_args(argv)

    if args.list:
        for arch, sname, ok, why in iter_cells():
            print(f"{arch:24s} {sname:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return 0

    cells = []
    if args.all:
        for arch, sname, ok, why in iter_cells():
            if ok:
                cells.append((arch, sname))
    elif args.cells:
        cells += [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all or --cells)"
        cells.append((args.arch, args.shape))

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    failures = 0
    for arch, sname in cells:
        for mp in meshes:
            tag = f"{arch} × {sname} × {'2x16x16' if mp else '16x16'}"
            try:
                r = run_cell(arch, sname, multi_pod=mp,
                             opt_state_dtype=args.opt_state,
                             variant=args.variant, out_dir=args.out,
                             workers=args.workers)
                if "skipped" in r:
                    print(f"[SKIP] {tag}: {r['skipped']}", flush=True)
                    continue
                rt = r["roofline"]
                print(
                    f"[OK]   {tag}: trace={r['lower_s']}s "
                    f"args/dev={r['memory']['analytic_arg_bytes_per_dev']/2**30:.2f}GiB "
                    f"peak/dev={r['memory']['traced_peak_bytes']/2**30:.2f}GiB "
                    f"compute={rt['compute_s']*1e3:.2f}ms "
                    f"hbm={rt['memory_s']*1e3:.2f}ms "
                    f"coll={rt['collective_s']*1e3:.2f}ms",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 — report and continue
                failures += 1
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
