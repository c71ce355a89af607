"""Logical-axis sharding rules (MaxText-style) on DeviceMesh / DTensor.

Copy of ``repro/distributed/sharding.py``'s rule table and resolution:
weights and activations are annotated with *logical* axis names, and a
rule table maps each name to an ordered list of candidate mesh dims.  The
first candidate whose size divides the dimension is used (the kv-head dims
of GQA models, 8 heads, fall back to replication on a 16-wide ``model``
dim), and no mesh dim is used twice in one spec.

In PyTorch's idiom a :class:`~torch.distributed.device_mesh.DeviceMesh`
with named dims stands in for ``jax.sharding.Mesh``, and DTensor
placements for ``NamedSharding``:

- :func:`resolve_spec` gives the port's own spec: a tuple with, for each
  tensor dim, a mesh dim name, a tuple of names, or ``None``;
- :func:`named_sharding` turns it into a :class:`NamedSharding`, the mesh
  and one placement a mesh dim (a tensor dim sharded over a tuple of mesh
  dims is one ``Shard(i)`` on each of them);
- :func:`constrain` is a ``redistribute`` of a DTensor (JAX's
  ``with_sharding_constraint``), a no-op without a mesh or on a plain
  tensor;
- :func:`device_put_tree` puts a tree of full tensors onto a tree of
  shardings (``distribute_tensor``), JAX's ``jax.device_put``.

The active mesh and rules live in a thread-local, as in JAX, so model code
calls :func:`constrain` unconditionally.  While a mesh is active, plain
tensors that meet DTensors in one operation count as replicated
(``implicit_replication``): the positions, masks and frequencies the
model builds with ``torch.arange`` join the sharded activations as they
join JAX's under ``jit``.

:func:`local_call` runs a function on the local shards of its DTensor
arguments (``local_map``): the kernel entry points of
:mod:`repro_torch.kernels.ops` use it, so a kernel never sees a DTensor.
Under grad it sums the gradient of an argument taken replicated over the
mesh dims the call splits, as JAX's ``jit`` does; inside such a call
:func:`psum` and :func:`all_to_all` are the collectives with JAX's
gradients.
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

Axis = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Axis, ...]
# logical axis -> ordered candidate mesh-dim tuples (first that divides wins)
# None (replicate) is always the final fallback.
Rules = Dict[str, List[Axis]]

DEFAULT_RULES: Rules = {
    # activations
    "batch": [("pod", "data"), "data"],
    "dec_batch": [("pod", "data"), "data"],  # decode residual stream; the
                                             # serve_opt variant replicates
                                             # it (weight-stationary decode)
    "seq": [None],
    "seq_act": [None],                   # sequence parallel variant: ["model"]
    "kv_seq": ["model", None],           # decode KV-cache sequence dim
    "embed_act": [None],
    "heads_act": ["model", None],
    "ff_act": ["model", None],
    "vocab_act": ["model", None],
    # weights (2D: tensor axis on `model`, fsdp axis on `data`)
    "embed": ["data", None],             # fsdp / ZeRO-3 dim of weights
    "vocab": ["model", None],
    "heads": ["model", None],
    "kv_heads": ["model", None],
    "ff": ["model", None],
    "experts": ["model", None],
    "experts_ep": ["data", None],   # EP: expert dim over the data axis
    "expert_ff": ["data", None],
    "head_dim": [None],
    "lora": [None],
    "state": [None],
    "conv": [None],
    "none": [None],
}


class _Ctx(threading.local):
    def __init__(self) -> None:
        self.mesh = None
        self.rules: Rules = dict(DEFAULT_RULES)
        self.meshes_entered = 0   # ``use_mesh`` blocks with a mesh, open now


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Rules] = None):
    """Activate a mesh + rule table for logical sharding resolution."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    entered = mesh is not None
    _CTX.meshes_entered += entered
    try:
        # implicit replication is a flag its context manager clears on exit,
        # so only the first mesh entered sets it; a ``use_mesh(None)`` in
        # between leaves it on
        if entered and _CTX.meshes_entered == 1:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.meshes_entered -= entered
        _CTX.mesh, _CTX.rules = prev


def active_mesh():
    return _CTX.mesh


def mesh_shape(mesh) -> Mapping[str, int]:
    """``{dim name: size}`` of a DeviceMesh, or ``mesh.shape`` of any other
    mesh-like object (the JAX tests' ``FakeMesh``, a production mesh
    reckoned without ranks)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return mesh.shape


def _axis_size(shape: Mapping[str, int], axis: Union[str, Tuple[str, ...]]) -> int:
    if isinstance(axis, tuple):
        return int(math.prod(shape[a] for a in axis))
    return int(shape[axis])


def resolve_spec(
    logical: Sequence[Optional[str]],
    dim_sizes: Optional[Sequence[int]] = None,
    mesh=None,
    rules: Optional[Rules] = None,
) -> Spec:
    """Logical names -> the port's spec under the active mesh and rules.

    ``dim_sizes`` enables divisibility fallbacks; without it the first
    candidate present in the mesh is used.  Mesh dims are never assigned
    twice in one spec.  Without a mesh the spec is ``()``, as JAX's
    ``P()``.
    """
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return ()
    shape = mesh_shape(mesh)
    used: set = set()
    out: List[Axis] = []
    for i, name in enumerate(logical):
        if name is None:
            out.append(None)
            continue
        cands = rules.get(name, [None])
        picked = None
        for cand in cands:
            if cand is None:
                break
            axes = cand if isinstance(cand, tuple) else (cand,)
            if any(a not in shape for a in axes):
                continue
            if any(a in used for a in axes):
                continue
            if dim_sizes is not None:
                size = _axis_size(shape, cand)
                if dim_sizes[i] % size != 0:
                    continue
            picked = cand
            break
        if picked is not None:
            used.update(picked if isinstance(picked, tuple) else (picked,))
        out.append(picked)
    return tuple(out)


def placements_of(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements (one a mesh dim) of a spec on a DeviceMesh.

    A tensor dim sharded over a tuple of mesh dims is a ``Shard`` on each,
    which DTensor splits in mesh-dim order: the tuple must list them in
    that order (``("pod", "data")`` on a ``("pod", "data", "model")``
    mesh), as JAX's major-to-minor order does.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    for i, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"mesh dims {axes} of tensor dim {i} are not in the mesh's "
                             f"order {tuple(names)}")
        for p in pos:
            out[p] = Shard(i)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and one DTensor placement a mesh dim (``mesh, placements =``
    unpacks it); a leaf of a sharding tree."""

    mesh: Any
    placements: Tuple[Any, ...]

    def __iter__(self):
        return iter((self.mesh, self.placements))


def named_sharding(
    logical: Sequence[Optional[str]],
    dim_sizes: Optional[Sequence[int]] = None,
    mesh=None,
) -> Optional[NamedSharding]:
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, placements_of(resolve_spec(logical, dim_sizes, mesh), mesh))


def is_dtensor(x) -> bool:
    # nothing is a DTensor before its module is imported, and the
    # one-device path never imports it
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def any_dtensor(*xs) -> bool:
    return any(is_dtensor(x) for x in xs)


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """``redistribute`` of a DTensor under the active mesh; a no-op without
    one or on a plain tensor."""
    mesh = _CTX.mesh
    if mesh is None or not is_dtensor(x):
        return x
    spec = resolve_spec(logical, x.shape, mesh)
    return x.redistribute(mesh, placements_of(spec, mesh))


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its ``Partial`` placements summed into ``Replicate`` (an
    all-reduce over each such mesh dim); a plain tensor, or one with no
    ``Partial``, as it is.  For a product over a sharded dim that a
    differently placed tensor meets next: some torch versions cannot make
    that tensor ``Partial`` to match."""
    from torch.distributed.tensor import Partial, Replicate

    if not is_dtensor(x) or not any(isinstance(pl, Partial) for pl in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if isinstance(pl, Partial) else pl
                                          for pl in x.placements])


def _is_container(x) -> bool:
    """A dict, or a tuple/list of subtrees (the VLM's and Whisper's
    ``(k, v)`` pairs), never a shape tuple of ints."""
    if isinstance(x, dict):
        return True
    return isinstance(x, (tuple, list)) and not all(isinstance(n, int) for n in x)


def _map2(fn, spec_tree, other):
    """``fn(spec_leaf, other_leaf)`` over two matching trees whose spec
    leaves are tuples; the structure is read from ``other``."""
    if isinstance(other, dict):
        return {k: _map2(fn, spec_tree[k], v) for k, v in other.items()}
    if _is_container(other):
        return type(other)(_map2(fn, sp, o) for sp, o in zip(spec_tree, other))
    return fn(spec_tree, other)


def tree_shardings(spec_tree, shape_tree, mesh=None):
    """A tree of logical-name tuples + matching shapes (tensors, or shape
    tuples) -> a tree of :class:`NamedSharding`."""
    mesh = mesh or _CTX.mesh

    def one(logical, shaped):
        shape = shaped.shape if hasattr(shaped, "shape") else shaped
        return NamedSharding(mesh, placements_of(resolve_spec(logical, shape, mesh), mesh))

    return _map2(one, spec_tree, shape_tree)


def device_put_tree(tree, shardings):
    """``jax.device_put(tree, shardings)``: every full tensor of ``tree``
    distributed onto its :class:`NamedSharding` (``distribute_tensor``,
    rank 0's values), a DTensor redistributed; a ``None`` sharding leaves
    its tensor as it is."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: device_put_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(device_put_tree(v, sh) for v, sh in zip(tree, shardings))
    if shardings is None:
        return tree
    mesh, placements = shardings
    if is_dtensor(tree):
        return tree.redistribute(mesh, list(placements))
    return distribute_tensor(tree, mesh, list(placements))


def _grad_placements(in_placements: Sequence[Any], ndim: int) -> Tuple[Any, ...]:
    """The placements of each argument's gradient in a :func:`local_call`:
    an argument replicated on a mesh dim that shards another argument
    gets a gradient that is ``Partial`` there (each rank's covers only its
    own rows, experts or columns; DTensor sums them), one sharded keeps
    its placements."""
    from torch.distributed.tensor import Partial, Replicate

    split = [any(pls is not None and not isinstance(pls[m], Replicate)
                 for pls in in_placements) for m in range(ndim)]
    return tuple(None if pls is None else
                 [Partial() if split[m] and isinstance(pl, Replicate) else pl
                  for m, pl in enumerate(pls)] for pls in in_placements)


def local_call(fn: Callable, args: Sequence[Any], in_placements: Sequence[Any],
               out_placements, mesh) -> Any:
    """``fn`` on the local shards of ``args`` (``local_map``): each tensor
    argument is redistributed to its entry of ``in_placements`` (``None``
    for an argument that is not a tensor) and the outputs are DTensors
    with ``out_placements``.  A plain tensor argument counts as
    replicated.

    Under grad, an argument taken as replicated on a mesh dim over which
    another argument is sharded gets its gradient summed over that dim
    (:func:`_grad_placements`): ``fn`` must then split its work over that
    dim, its outputs sharded or partial there or summed inside it (with
    :func:`psum`), as every body in the port does.  Without it RMSNorm's
    gamma and the scan's ``A`` and ``D`` would get only a rank's rows'
    share of their gradient on a ``data``-sharded mesh."""
    from torch.distributed.tensor import DTensor, Placement, Replicate
    from torch.distributed.tensor.experimental import local_map

    def one(pls):
        # one output's placements: a list; several outputs: a tuple of them
        if pls is None or all(isinstance(p, Placement) for p in pls):
            return None if pls is None else list(pls)
        return tuple(one(p) for p in pls)

    rep = [Replicate()] * mesh.ndim
    args = [DTensor.from_local(a, mesh, rep, run_check=False)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) else a for a in args]
    in_pls = tuple(one(p) for p in in_placements)
    return local_map(fn, out_placements=one(out_placements), in_placements=in_pls,
                     in_grad_placements=_grad_placements(in_pls, mesh.ndim),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


class _PSum(torch.autograd.Function):
    """Sum over a process group; the gradient passes through unchanged
    (JAX's ``psum`` inside ``shard_map``: the result is the same on every
    rank of the group, so is its gradient, which is each term's)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor), differentiable as JAX's
    ``psum``."""
    return _PSum.apply(x, group)


class _AllToAll(torch.autograd.Function):
    """JAX's tiled ``all_to_all`` over dim 0, whose gradient is the reverse
    exchange (the same exchange: block j of rank i went to block i of
    rank j)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a_blocks(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _a2a_blocks(dy, ctx.group), None


def _a2a_blocks(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal row blocks of ``x``, block j to the group's rank j, received
    blocks in rank order; differentiable."""
    return _AllToAll.apply(x, group)


def shard_offsets(x, placements=None) -> List[Tuple[int, int]]:
    """``(global offset, local size)`` of this rank's shard of DTensor ``x``
    (laid out as ``placements``, by default its own) along each tensor
    dim: DTensor's ``torch.chunk`` split, mesh dims in order."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    out = [[0, n] for n in x.shape]
    for m, pl in enumerate(x.placements if placements is None else placements):
        if isinstance(pl, Shard):
            d = pl.dim
            off, n = out[d]
            chunk = -(-n // mesh.size(m))
            start = min(n, coord[m] * chunk)
            out[d] = [off + start, min(chunk, n - start)]
    return [tuple(o) for o in out]


def local_shard(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``x`` laid out as ``placements`` (a plain
    tensor counts as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return x.redistribute(mesh, list(placements)).to_local()


def narrow_copy_(dst: torch.Tensor, dim: int, src: torch.Tensor) -> None:
    """``dst.narrow(dim, 0, src.shape[dim]).copy_(src)``, in place also on
    a DTensor ``dst``, whatever dims it shards: each rank copies the part
    of ``src`` its shard of ``dst`` holds."""
    if not is_dtensor(dst):
        dst.narrow(dim, 0, src.shape[dim]).copy_(src)
        return
    from torch.distributed.tensor import Replicate, Shard

    dim %= dst.dim()
    pls = [Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
           for pl in dst.placements]
    src_l = local_shard(src, dst.device_mesh, pls)
    off, n = shard_offsets(dst)[dim]
    hi = min(off + n, src.shape[dim])
    if hi > off:
        dst.to_local().narrow(dim, 0, hi - off).copy_(src_l.narrow(dim, off, hi - off))


def unflatten(x: torch.Tensor, dim: int, sizes: Tuple[int, ...]) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``; a DTensor sharded on ``dim`` over mesh
    dims whose sizes do not divide ``sizes[0]`` (six heads of a 96-wide
    projection over a 4-wide ``model``) is gathered on it first, as each
    shard must hold whole leading groups."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        dim %= x.dim()
        mesh = x.device_mesh
        on = [isinstance(pl, Shard) and pl.dim == dim for pl in x.placements]
        if sizes[0] % math.prod(mesh.size(m) for m, o in enumerate(on) if o):
            x = x.redistribute(mesh, [Replicate() if o else pl
                                      for o, pl in zip(on, x.placements)])
    return x.unflatten(dim, sizes)


class _MergeLast2(torch.autograd.Function):
    """``x.flatten(-2)`` whose gradient is split back by :func:`unflatten`."""

    @staticmethod
    def forward(ctx, x):
        ctx.sizes = tuple(x.shape[-2:])
        return x.flatten(-2)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, -1, ctx.sizes)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x.flatten(-2)``: an attention output's heads and head dim merged.

    On a DTensor that needs a gradient, the gradient (sharded on the
    merged dim by the output projection) is split back through
    :func:`unflatten`, which gathers it first where the shards do not hold
    whole heads (Whisper's six heads over a 16-wide ``model``): DTensor's
    own view refuses that split."""
    if is_dtensor(x) and x.requires_grad:
        return _MergeLast2.apply(x)
    return x.flatten(-2)
