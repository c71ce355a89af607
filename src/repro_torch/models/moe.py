"""Mixture-of-Experts: the dense oracle, the one-device block and the
expert-parallel path.

Port of ``repro/models/moe.py``: ``init_moe``, ``_routing``,
``moe_dense``, ``moe_ep`` with its bodies ``_ep_body`` and
``_ep_body_dedup``, and ``moe_block``:

- float32 router softmax, top-k, gates renormalized to sum to one;
- each chosen expert's gated MLP in the model dtype;
- the experts' outputs weighted and summed in float32, then cast;
- the shared experts (DeepSeek, Kimi), when the config has them, as one
  gated MLP of width ``n_shared * d_ff_expert`` over every token, added
  to the cast routed sum in the model dtype (JAX's order: in bf16 the
  other order gives other bits).

:func:`moe_dense` runs every expert on every token (the oracle the tests
hold the port against).  Without a mesh, :func:`moe_block` computes the
same function and reads only the chosen experts' weights: the assignments
are sorted by expert, each expert multiplies its own tokens, and an
accumulating ``index_put_`` sums the weighted outputs in float32.

Under a mesh (:mod:`repro_torch.distributed.sharding`), ``impl="ep"``
runs :func:`moe_ep` on the local shards, where JAX runs ``shard_map``:
fixed-capacity packing (Python-int capacities, the same stable argsort
and overflow slot, so the same assignments are dropped), an
``all_to_all_single`` over the ``data`` group with equal splits (JAX's
tiled ``all_to_all``; the int8 dispatch sends the payload and its
scales), a grouped GEMM over the local experts (one product an expert:
``ragged_dot`` is a plain product in JAX too), the return
``all_to_all``, the combine in ``combine_dtype`` (each token's terms
added in a fixed order, where JAX's ``segment_sum`` leaves the order
open) and a sum over ``model`` (``psum``: the gradient passes through, as
JAX's).  Where JAX's ``moe_ep`` falls
back to ``moe_dense``, the port falls back to the one-device body, on the
local expert shards when the weights are DTensors.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import sharding as shd
from .config import ModelConfig
from .layers import Init, Params, Shape, init_mlp, mlp


def init_moe(init: Init, cfg: ModelConfig, lead: Shape = ()) -> Params:
    """Router and expert weights, stacked over ``lead``.

    The expert tensors use the JAX package's default fan-in, the first
    axis of the unstacked shape (the expert count).  With ``n_shared``
    shared experts the tree gains ``shared``: a gated MLP's
    ``w_gate``/``w_up``/``w_down`` of width ``n_shared * d_ff_expert``.
    """
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_ff_expert
    p = {
        "router": init.dense(lead + (d, E), fan_in=d, spec=("embed", "experts")),
        # expert dim -> data (EP), ffn dim -> model (TP)
        "w_gate": init.dense(lead + (E, d, f), fan_in=E, spec=("experts_ep", None, "ff")),
        "w_up": init.dense(lead + (E, d, f), fan_in=E, spec=("experts_ep", None, "ff")),
        "w_down": init.dense(lead + (E, f, d), fan_in=E, spec=("experts_ep", "ff", None)),
    }
    if m.n_shared > 0:
        p["shared"] = init_mlp(init, d, m.n_shared * f, lead)
    return p


def _routing(p: Params, cfg: ModelConfig,
             x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (T, k) float32, expert ids (T, k)) of each token."""
    logits = (x2d @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, ids


def moe_dense(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Oracle: run all experts on all tokens (small configs only)."""
    m = cfg.moe
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    w, ids = _routing(p, cfg, x2d)
    comb = torch.zeros((x2d.shape[0], m.n_experts), dtype=torch.float32,
                       device=x.device).scatter_add_(1, ids, w)
    h = torch.einsum("td,edf->tef", x2d, p["w_gate"])
    u = torch.einsum("td,edf->tef", x2d, p["w_up"])
    y_e = torch.einsum("tef,efd->ted", F.silu(h) * u, p["w_down"])
    y = torch.einsum("ted,te->td", y_e.float(), comb).to(x.dtype)
    if m.n_shared > 0:
        y = y + mlp(p["shared"], x2d)
    return y.reshape(B, S, d)


def _routed_sum(x2d: torch.Tensor, w: torch.Tensor, ids: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor,
                e0: Optional[int] = None) -> torch.Tensor:
    """The float32 sum, over each token's assignments, of the gate times
    the chosen expert's gated MLP; reads only the chosen experts' weights.
    With ``e0``, ``w_gate`` etc. hold experts ``e0`` .. ``e0 + E_l - 1``
    only (a rank's shard) and the other assignments are left out.

    The assignments are sorted by expert, each expert multiplies its own
    tokens, and an accumulating ``index_put_`` sums the weighted outputs.
    One host sync a call (the per-expert token counts).
    """
    E_l = w_gate.shape[0]
    flat = ids.reshape(-1) if e0 is None else ids.reshape(-1) - e0
    order = torch.argsort(flat, stable=True)
    tok = order // ids.shape[-1]
    gate = w.reshape(-1)[order]
    start, counts = _expert_counts(flat, E_l, e0)
    y = torch.zeros((x2d.shape[0], w_down.shape[-1]), dtype=torch.float32, device=x2d.device)
    for e, n in enumerate(counts):
        if n == 0:
            continue
        t_e = tok[start:start + n]
        xe = x2d[t_e]
        act = F.silu(xe @ w_gate[e]) * (xe @ w_up[e])
        # index_add_'s sum; index_put_ takes ~1000x less time on the CPU here
        y.index_put_((t_e,), (act @ w_down[e]).float() * gate[start:start + n, None],
                     accumulate=True)
        start += n
    return y


def _expert_counts(flat: torch.Tensor, E_l: int, e0: Optional[int]) -> Tuple[int, List[int]]:
    """``_routed_sum``'s split of the assignments ``flat`` (expert ids,
    less ``e0`` on a shard), as Python ints: how many lie below the
    shard's first expert, and each of its ``E_l`` experts' count."""
    if e0 is None:
        return 0, torch.bincount(flat, minlength=E_l).tolist()
    # [below e0, expert 0 .. E_l - 1, past them]
    start, *counts = torch.bincount(flat.clamp(-1, E_l) + 1, minlength=E_l + 2).tolist()
    return start, counts[:E_l]


def _moe_one_device(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """``moe_dense``'s function on one device, reading only the chosen
    experts' weights."""
    m = cfg.moe
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    w, ids = _routing(p, cfg, x2d)
    y = _routed_sum(x2d, w, ids, p["w_gate"], p["w_up"], p["w_down"]).to(x.dtype)
    if m.n_shared > 0:
        y = y + mlp(p["shared"], x2d)
    return y.reshape(B, S, d)


def _moe_sharded(p: Params, cfg: ModelConfig, x: torch.Tensor, mesh) -> torch.Tensor:
    """``moe_dense``'s function on a mesh without expert-parallel dispatch
    (JAX's fallback, which XLA partitions): every rank routes all tokens,
    runs the tokens its local experts (and FFN columns) take, and the
    float32 partial sums are reduced over the mesh dims that shard the
    experts, then cast.  The expert weights never move."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    m = cfg.moe
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    wg = p["w_gate"]
    # the expert weights as they lie, on their expert and FFN dims only
    kept = [pl if isinstance(pl, Shard) and pl.dim in (0, 2) else Replicate()
            for pl in (wg.placements if shd.is_dtensor(wg) else [Replicate()] * mesh.ndim)]
    down = [Shard(1) if isinstance(pl, Shard) and pl.dim == 2 else pl for pl in kept]
    rep = [Replicate()] * mesh.ndim
    out = [Partial() if isinstance(pl, Shard) else Replicate() for pl in kept]
    e0 = shd.shard_offsets(wg, kept)[0][0] if shd.is_dtensor(wg) else 0

    def body(xl, router, wgl, wul, wdl):
        w, ids = _routing({"router": router}, cfg, xl)
        return _routed_sum(xl, w, ids, wgl, wul, wdl, e0=e0)

    y = shd.local_call(body, [x2d, p["router"], wg, p["w_up"], p["w_down"]],
                       [rep, rep, kept, kept, down], out, mesh)
    y = y.redistribute(mesh, rep).to(x.dtype)
    if m.n_shared > 0:
        y = y + mlp(p["shared"], x2d)
    return y.reshape(B, S, d)


def _moe_fallback(p: Params, cfg: ModelConfig, x: torch.Tensor, mesh) -> torch.Tensor:
    if mesh is not None and shd.any_dtensor(x, p["router"], p["w_gate"], p["w_up"],
                                            p["w_down"]):
        return _moe_sharded(p, cfg, x, mesh)
    return _moe_one_device(p, cfg, x)


# ---------------------------------------------------------------------------
# Expert-parallel path
# ---------------------------------------------------------------------------
#: calls of each expert-parallel body and of the fallback since the last
#: reset (the card shows which one a sharded run took)
EP_CALLS = {"ep_body": 0, "ep_body_dedup": 0, "fallback": 0}


def reset_ep_calls() -> None:
    for k in EP_CALLS:
        EP_CALLS[k] = 0


def _q8_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rowwise int8 payload and float32 scales of the int8 dispatch."""
    rf = rows.float()
    scl = torch.clamp_min(rf.abs().amax(-1), 1e-8) / 127.0
    return torch.clamp(torch.round(rf / scl[:, None]), -127, 127).to(torch.int8), scl


def _group_counts(eid: torch.Tensor, E_l: int) -> List[int]:
    """The rows of each of ``E_l`` local experts in the expert-parallel
    bodies' grouped GEMM (``eid`` >= ``E_l``: no local expert), as Python
    ints."""
    return torch.bincount(eid.clamp(0, E_l), minlength=E_l + 1)[:E_l].tolist()


def _grouped_mlp(rows: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, counts: List[int]) -> torch.Tensor:
    """JAX's three ``ragged_dot`` calls: the rows, sorted by local expert,
    through their expert's gated MLP (silu·u in float32, cast to the rows'
    dtype); rows past the groups give zeros.  One product an expert."""
    out = torch.zeros((rows.shape[0], w_down.shape[-1]), dtype=rows.dtype, device=rows.device)
    start = 0
    for e, n in enumerate(counts):
        if n:
            r = rows[start:start + n]
            act = (F.silu((r @ w_gate[e]).float()) * (r @ w_up[e]).float()).to(rows.dtype)
            out[start:start + n] = act @ w_down[e]
        start += n
    return out


def _sum_rows(rows: torch.Tensor, idx: torch.Tensor, w: Optional[torch.Tensor] = None,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Row ``i`` of the result is the sum over ``j`` of ``rows[idx[i, j]]``
    (times ``w[i, j]`` in the rows' dtype), cast to ``dtype`` and added in
    the order of ``j``.  JAX's ``segment_sum`` of the same terms, in a fixed
    order: ``index_add_`` on the card adds with atomics, so its float sums
    round differently from run to run."""
    y = torch.zeros((idx.shape[0], rows.shape[-1]), dtype=dtype, device=rows.device)
    for j in range(idx.shape[1]):
        r = rows[idx[:, j]]
        if w is not None:
            r = r * w[:, j, None].to(r.dtype)
        y = y + r.to(dtype)
    return y


def _unsort(v: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``v`` given in ``order``, back in the original order."""
    out = torch.empty_like(v)
    out[order] = v
    return out


def _ep_body_dedup(
    x_local: torch.Tensor,         # (T_l, d)
    router: torch.Tensor,          # (d, E)
    w_gate: torch.Tensor,          # (E_l, d, f_l)
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    cfg: ModelConfig,
    ep_rank: int,
    ep_size: int,
    ep_group,
    tp_group,
) -> torch.Tensor:
    """Deduplicated dispatch: one row per (token, destination shard).

    Top-k routing sends each token row up to k times; here a token's row
    crosses the wire once per *shard* owning ≥1 of its experts, with the
    (local expert id, gate weight) list piggybacked.  With
    ``shard_groups`` the destination count is capped.  Receivers expand
    pairs back to assignments locally for the grouped GEMM.
    """
    EP_CALLS["ep_body_dedup"] += 1
    m = cfg.moe
    T_l, d = x_local.shape
    dev = x_local.device
    dsize = ep_size
    E_l = w_gate.shape[0]
    k = m.top_k

    logits = (x_local @ router).float()
    probs = torch.softmax(logits, dim=-1)
    if m.shard_groups and m.shard_groups < dsize:
        # group-limited routing: keep only the top-L shards by mass
        shard_mass = probs.reshape(T_l, dsize, E_l).sum(-1)      # (T_l, ds)
        _, top_shards = torch.topk(shard_mass, m.shard_groups, dim=-1)
        allowed = torch.zeros((T_l, dsize), dtype=torch.bool, device=dev)
        allowed[torch.arange(T_l, device=dev)[:, None], top_shards] = True
        probs = torch.where(allowed.repeat_interleave(E_l, dim=1), probs, 0.0)
        max_dest = m.shard_groups
    else:
        max_dest = min(k, dsize)
    w, ids = torch.topk(probs, k, dim=-1)
    w = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)).float()
    dest = ids // E_l                                            # (T_l, k)
    leid = ids - dest * E_l

    # dense (token, shard) pair table
    shard_iota = torch.arange(dsize, device=dev)[None, :, None]  # (1, ds, 1)
    hit = dest[:, None, :] == shard_iota                         # (T_l, ds, k)
    pair_eid = torch.where(hit, leid[:, None, :], E_l).to(torch.int32)
    pair_w = torch.where(hit, w[:, None, :], 0.0).float()
    pair_exists = hit.any(-1)                                    # (T_l, ds)

    # fixed-capacity packing of pairs per destination
    A = T_l * dsize
    flat_dest = torch.arange(dsize, device=dev).repeat(T_l)
    flat_tok = torch.arange(T_l, device=dev).repeat_interleave(dsize)
    sort_key = torch.where(pair_exists.reshape(-1), flat_dest, dsize)
    cap = max(8, int(T_l * max_dest * m.capacity_factor) // max(1, dsize))
    order = torch.argsort(sort_key, stable=True)
    s_dest = sort_key[order]
    starts = torch.searchsorted(s_dest, torch.arange(dsize, device=dev))
    # JAX clamps the out-of-range gather at s_dest == dsize (no pair)
    rank = torch.arange(A, device=dev) - starts[s_dest.clamp(max=dsize - 1)]
    keep = (rank < cap) & (s_dest < dsize)
    slot = torch.where(keep, s_dest * cap + rank, dsize * cap)

    R = dsize * cap
    send_rows = torch.zeros((R + 1, d), dtype=x_local.dtype, device=dev)
    send_rows[slot] = x_local[flat_tok[order]]
    send_eid = torch.full((R + 1, k), E_l, dtype=torch.int32, device=dev)
    send_eid[slot] = pair_eid.reshape(A, k)[order]
    send_w = torch.zeros((R + 1, k), dtype=torch.float32, device=dev)
    send_w[slot] = pair_w.reshape(A, k)[order]

    if m.dispatch_dtype == "int8":
        q8, scl = _q8_rows(send_rows[:-1])
        recv_rows = (shd.all_to_all(q8, ep_group).float()
                     * shd.all_to_all(scl[:, None], ep_group)).to(x_local.dtype)
    else:
        recv_rows = shd.all_to_all(send_rows[:-1], ep_group)
    recv_eid = shd.all_to_all(send_eid[:-1], ep_group)
    recv_w = shd.all_to_all(send_w[:-1], ep_group)

    # --- receiver: expand pairs -> assignments (local memory, not wire) ---
    C2 = max(8, int(T_l * k * m.capacity_factor) // max(1, dsize) * dsize)
    C2 = min(C2, R * k)
    a_eid = recv_eid.reshape(-1)                                  # (R*k,)
    a_pair = torch.arange(R, device=dev).repeat_interleave(k)
    g_order = torch.argsort(torch.where(a_eid < E_l, a_eid, E_l), stable=True)[:C2]
    rows = recv_rows[a_pair[g_order]]                             # (C2, d)
    sel_eid = a_eid[g_order]
    yr = _grouped_mlp(rows, w_gate, w_up, w_down, _group_counts(sel_eid, E_l))   # (C2, d)
    # each pair's outputs summed in ascending local expert order; an
    # assignment past C2 or with no expert reads the zero row
    row_of = torch.full((R * k,), C2, dtype=torch.long, device=dev)
    row_of[g_order] = torch.arange(C2, device=dev)
    by_e = torch.argsort(recv_eid, dim=-1, stable=True)           # (R, k)
    yr = torch.cat([yr.float(), torch.zeros((1, d), device=dev)])
    y_pairs = _sum_rows(yr, row_of.reshape(R, k).gather(1, by_e),
                        (recv_w * (recv_eid < E_l)).gather(1, by_e))

    # --- return + combine -------------------------------------------------
    comb_dt = torch.float32 if m.combine_dtype == "float32" else torch.bfloat16
    back = shd.all_to_all(y_pairs.to(comb_dt), ep_group)      # (R, d)
    back = torch.cat([back, torch.zeros((1, d), dtype=back.dtype, device=dev)])
    # each token's pairs in destination order; a pair never sent reads
    # the zero row
    y = _sum_rows(back, _unsort(slot, order).reshape(T_l, dsize))
    if tp_group is not None:
        y = shd.psum(y, tp_group)
    return y.to(x_local.dtype)


def _ep_body(
    x_local: torch.Tensor,         # (T_l, d) tokens of this (pod, data) shard
    router: torch.Tensor,          # (d, E) replicated
    w_gate: torch.Tensor,          # (E_l, d, f_l)
    w_up: torch.Tensor,            # (E_l, d, f_l)
    w_down: torch.Tensor,          # (E_l, f_l, d)
    cfg: ModelConfig,
    ep_rank: int,
    ep_size: int,
    ep_group,
    tp_group,
) -> torch.Tensor:
    EP_CALLS["ep_body"] += 1
    m = cfg.moe
    T_l, d = x_local.shape
    dev = x_local.device
    E = m.n_experts
    didx = ep_rank
    dsize = ep_size  # capacity/slot shapes below are Python ints
    E_l = w_gate.shape[0]
    A = T_l * m.top_k                                   # assignments

    w, ids = _routing({"router": router}, cfg, x_local)  # (T_l, k)
    flat_eid = ids.reshape(-1)
    flat_w = w.reshape(-1)
    flat_tok = torch.arange(T_l, device=dev).repeat_interleave(m.top_k)
    dest = flat_eid // E_l                               # owning data shard

    # --- pack into fixed-capacity per-destination slots -------------------
    cap = max(8, int(A * m.capacity_factor) // max(1, dsize))
    order = torch.argsort(dest, stable=True)             # group by dest
    s_dest = dest[order]
    # rank within destination group
    starts = torch.searchsorted(s_dest, torch.arange(dsize, device=dev))
    rank = torch.arange(A, device=dev) - starts[s_dest]
    keep = rank < cap
    slot = torch.where(keep, s_dest * cap + rank, dsize * cap)  # overflow slot

    send_rows = torch.zeros((dsize * cap + 1, d), dtype=x_local.dtype, device=dev)
    send_rows[slot] = x_local[flat_tok[order]]
    send_eid = torch.full((dsize * cap + 1,), E * dsize, dtype=torch.int32, device=dev)
    send_eid[slot] = flat_eid[order].to(torch.int32)

    payload = send_rows[:-1]
    if m.dispatch_dtype == "int8":
        # quantized dispatch: rowwise int8 payload + f32 scales
        q8, scl = _q8_rows(payload)
        recv_q = shd.all_to_all(q8, ep_group)
        recv_s = shd.all_to_all(scl[:, None], ep_group)[:, 0]
        recv_rows = (recv_q.float() * recv_s[:, None]).to(x_local.dtype)
    else:
        recv_rows = shd.all_to_all(payload, ep_group)
    recv_eid = shd.all_to_all(send_eid[:-1].reshape(dsize * cap, 1), ep_group)[:, 0]

    # --- local grouped GEMM ------------------------------------------------
    leid = recv_eid - didx * E_l                          # local expert id
    valid = (leid >= 0) & (leid < E_l)
    leid = torch.where(valid, leid, E_l)
    g_order = torch.argsort(leid, stable=True)
    rows = recv_rows[g_order]
    yr = _grouped_mlp(rows, w_gate, w_up, w_down,
                      _group_counts(leid, E_l))   # (R, d) partial over f
    # unsort back to slot order; zero the invalid rows
    inv = torch.empty_like(g_order)
    inv[g_order] = torch.arange(g_order.shape[0], device=dev)
    yr = yr[inv] * valid[:, None]

    # --- return to source shards + combine ---------------------------------
    back = shd.all_to_all(yr, ep_group)                   # (dsize*cap, d)
    back = torch.cat([back, torch.zeros((1, d), dtype=back.dtype, device=dev)])
    comb_dt = torch.float32 if m.combine_dtype == "float32" else torch.bfloat16
    # each token's k outputs summed in ascending expert order, the order in
    # which the one-device body adds them; a dropped one reads the zero row
    by_e = torch.argsort(ids, dim=-1, stable=True)                # (T_l, k)
    y = _sum_rows(back, _unsort(slot, order).reshape(T_l, m.top_k).gather(1, by_e),
                  (flat_w * _unsort(keep, order)).reshape(T_l, m.top_k).gather(1, by_e),
                  comb_dt)
    if tp_group is not None:
        y = shd.psum(y, tp_group)                         # sum FFN partials
    return y.to(x_local.dtype)


def moe_ep(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Expert-parallel MoE on the local shards of a mesh.

    Tokens are sharded over (pod, data) and replicated over ``model``;
    expert weights have their expert dim over ``data`` and their FFN dim
    over ``model``.  Falls back to ``moe_dense``'s function where JAX's
    does: without a mesh, without a ``data`` dim that divides the experts,
    or with a token count the token shards do not divide or that leaves a
    shard fewer tokens than ``top_k``.  Returns a DTensor sharded as the
    tokens.
    """
    mesh = shd.active_mesh()
    m = cfg.moe
    shape = shd.mesh_shape(mesh) if mesh is not None else {}
    if mesh is None or "data" not in shape or m.n_experts % shape["data"]:
        EP_CALLS["fallback"] += 1
        return _moe_fallback(p, cfg, x, mesh)
    n_tok = x.shape[0] * x.shape[1]
    tok_shards = shape["data"] * shape.get("pod", 1)
    if n_tok % tok_shards or (n_tok // tok_shards) < m.top_k:
        # decode-style tiny token counts: dense dispatch is cheaper than
        # a degenerate all_to_all
        EP_CALLS["fallback"] += 1
        return _moe_fallback(p, cfg, x, mesh)
    tp_axis = "model" if "model" in shape else None
    if tp_axis and m.d_ff_expert % shape[tp_axis]:
        tp_axis = None

    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    batch_axes: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in shape)
    body_fn = _ep_body_dedup if m.dedup_dispatch else _ep_body
    ep_group = mesh.get_group("data")
    tp_group = mesh.get_group(tp_axis) if tp_axis else None

    def body(xl, router, wg, wu, wd):
        return body_fn(xl, router, wg, wu, wd, cfg, ep_rank=mesh.get_local_rank("data"),
                       ep_size=shape["data"], ep_group=ep_group, tp_group=tp_group)

    def pl(*spec):
        return shd.placements_of(spec, mesh)

    y2d = shd.local_call(
        body, [x2d, p["router"], p["w_gate"], p["w_up"], p["w_down"]],
        [pl(batch_axes, None), pl(None, None), pl("data", None, tp_axis),
         pl("data", None, tp_axis), pl("data", tp_axis, None)],
        pl(batch_axes, None), mesh)
    if m.n_shared > 0:
        y2d = y2d + mlp(p["shared"], x2d)
    return y2d.reshape(B, S, d)


def moe_block(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MoE FFN: ``impl="ep"`` under an active mesh is :func:`moe_ep`;
    otherwise ``moe_dense``'s function, reading only the chosen experts'
    weights (on a mesh, on their local shards)."""
    mesh = shd.active_mesh()
    if cfg.moe.impl == "ep" and mesh is not None:
        return moe_ep(p, cfg, x)
    return _moe_fallback(p, cfg, x, mesh)
