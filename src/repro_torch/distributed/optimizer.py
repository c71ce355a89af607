"""Optimizers: AdamW with optional 8-bit state quantization.

Copy of ``repro/distributed/optimizer.py``: ``OptConfig``, the row-wise
int8 codec (``_q8``/``_dq8``, ``QTensor``), ``init_opt_state``, ``_lr_at``
and ``adamw_update`` with the same float32 math — the global-norm clip,
bias correction, and decoupled weight decay applied to the float32 copy of
the parameter, then one cast back to the parameter's dtype.  8-bit state
(row-wise symmetric int8 ``m``/``v`` with float32 scales a row) holds a
quarter of the float32 state's bytes.

Trees are nested dicts of tensors; leaves are visited in the JAX package's
order (dict keys sorted), so the gradient norm sums in the same order.

On a mesh the parameters, their gradients and the state are DTensors
placed alike (``init_opt_state``), and the update runs on each rank's
shards; the clip's norm is over whole leaves.

One departure in form, not in values: JAX donates the parameters and the
state to its jitted step, and this module updates both **in place** under
``torch.no_grad()`` (a float32 state leaf is overwritten, an int8 one
rebuilt; a parameter is written through ``copy_``).  ``adamw_update``
still returns ``(new_params, new_state, metrics)`` as JAX does; the
returned trees hold the caller's tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple, Union

import torch

from . import sharding as shd


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"     # "float32" | "int8"
    warmup_steps: int = 100


# -- int8 state codec --------------------------------------------------------
def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise symmetric int8 quantization (last dim is the block).

    ``torch.round`` rounds half to even, as ``jnp.round`` does, so equal
    inputs give bit-equal codes and scales.
    """
    if x.dim() == 0:
        s = torch.clamp(x.abs(), min=1e-12) / 127.0
        return torch.round(x / s).to(torch.int8), s.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax, min=1e-12) / 127.0
    return torch.round(x / s).to(torch.int8), s.float()


def _dq8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


class QTensor(NamedTuple):
    q: torch.Tensor
    s: torch.Tensor


State = Union[torch.Tensor, QTensor]


def _encode(x: torch.Tensor, mode: str) -> State:
    if mode == "int8":
        q, s = _q8(x)
        if shd.is_dtensor(s):   # DTensor leaves its row reduction's layout open
            s = s.redistribute(s.device_mesh, _scale_placements(x.placements, x.dim()))
        return QTensor(q, s)
    return x


def _scale_placements(placements, ndim: int) -> tuple:
    """The int8 state's scales placed as their ``ndim``-dim leaf, but
    whole along its last dim (each row's scale reduces it)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if isinstance(pl, Shard) and pl.dim == ndim - 1 else pl
                 for pl in placements)


def _decode(x: State, mode: str) -> torch.Tensor:
    if mode == "int8":
        return _dq8(x.q, x.s)
    return x


# -- trees -------------------------------------------------------------------
def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in the JAX package's order (keys sorted);
    anything but a dict is a leaf (a ``QTensor`` too)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped as the nested dict ``like`` with ``leaves`` in its order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


# -- adamw -------------------------------------------------------------------
def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    """``{"step": int32 0, "mv": {leaf: {"m", "v"}}}``, zeros on each
    parameter's device (int8 state: codes and scales of zeros).

    On DTensor params ``m`` and ``v`` are DTensors placed as their
    parameter (int8: the codes so, the scales so but whole along the
    last dim, which each row's scale reduces); the step is a plain 0-dim
    tensor on every rank."""
    def one(p: torch.Tensor) -> Dict[str, State]:
        # distinct buffers for m and v: both are updated in place
        m, v = (torch.zeros_like(p, dtype=torch.float32) for _ in range(2))
        return {"m": _encode(m, cfg.state_dtype), "v": _encode(v, cfg.state_dtype)}

    first = tree_leaves(params)[0]
    dev = (first.to_local() if shd.is_dtensor(first) else first).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "mv": tree_unflatten(params, [one(p) for p in tree_leaves(params)]),
    }


def state_shardings(params_shardings, state) -> Dict[str, Any]:
    """The sharding tree of ``state`` (``init_opt_state``'s) for
    ``restore_checkpoint(shardings=)``: each ``m`` and ``v`` placed as its
    parameter in ``params_shardings`` (int8: the scales whole along the
    last dim), the step ``None`` (a plain tensor)."""
    def walk(sh, mv):
        if isinstance(sh, dict):
            return {k: walk(sh[k], mv[k]) for k in sh}
        return {k: QTensor(sh, shd.NamedSharding(sh.mesh, _scale_placements(
                    sh.placements, x.q.dim()))) if isinstance(x, QTensor) else sh
                for k, x in mv.items()}

    return {"step": None, "mv": walk(params_shardings, state["mv"])}


def _lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1).float() / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    """Returns ``(new_params, new_state, metrics)``, updating in place.

    ``grads`` is a tree shaped as ``params`` (a leaf may be ``None``: a
    parameter the loss does not use, whose gradient is zero, as JAX gives
    it).  ``metrics`` holds ``grad_norm`` and ``lr`` (0-dim float32).
    """
    step = state["step"] + 1
    lr = _lr_at(cfg, step)
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    flat_mv = tree_leaves(state["mv"])   # each parameter's m, then its v
    if not len(flat_p) == len(flat_g) == len(flat_mv) // 2:
        raise ValueError(f"params, grads and state differ in leaves: {len(flat_p)}, "
                         f"{len(flat_g)}, {len(flat_mv)} // 2")

    # global-norm clip (fp32), summed leaf by leaf in leaf order; a DTensor
    # leaf's sum is over the whole leaf (reduced over its shards)
    gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
    for g in flat_g:
        if g is not None:
            sq = torch.sum(torch.square(g.float()))
            gnorm = gnorm + (sq.full_tensor() if shd.is_dtensor(sq) else sq)
    gnorm = torch.sqrt(gnorm)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)

    new_mv = []
    for p, g, m_st, v_st in zip(flat_p, flat_g, flat_mv[0::2], flat_mv[1::2]):
        g = (torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()) * scale
        m = _decode(m_st, cfg.state_dtype)
        v = _decode(v_st, cfg.state_dtype)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        pf = p.float()
        pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf)
        p.copy_(pf)
        del g, mh, vh, pf
        if cfg.state_dtype == "int8":
            new_mv.append({"m": _encode(m, "int8"), "v": _encode(v, "int8")})
        else:
            m_st.copy_(m)
            v_st.copy_(v)
    state["step"] = step
    if cfg.state_dtype == "int8":
        state["mv"] = tree_unflatten(params, new_mv)
    return params, state, {"grad_norm": gnorm, "lr": lr}
