"""Mixture-of-Experts layers on one device.

Port of ``init_moe``, ``_routing`` and ``moe_dense`` of
``repro/models/moe.py``, and of ``moe_block`` as it runs on one device
(without a mesh the JAX package's expert-parallel ``moe_ep`` computes
``moe_dense``'s function):

- float32 router softmax, top-k, gates renormalized to sum to one;
- each chosen expert's gated MLP in the model dtype;
- the experts' outputs weighted and summed in float32, then cast;
- the shared experts (DeepSeek, Kimi), when the config has them, as one
  gated MLP of width ``n_shared * d_ff_expert`` over every token, added
  to the cast routed sum in the model dtype (JAX's order: in bf16 the
  other order gives other bits).

:func:`moe_dense` runs every expert on every token (the oracle the tests
hold the port against).  :func:`moe_block` computes the same function and
reads only the chosen experts' weights: the assignments are sorted by
expert, each expert multiplies its own tokens, and an accumulating
``index_put_`` sums the weighted outputs in float32.  The
expert-parallel dispatch (shard_map, all_to_all) waits for the
distributed slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

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
        "router": init.dense(lead + (d, E), fan_in=d),
        "w_gate": init.dense(lead + (E, d, f), fan_in=E),
        "w_up": init.dense(lead + (E, d, f), fan_in=E),
        "w_down": init.dense(lead + (E, f, d), fan_in=E),
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


def moe_block(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MoE FFN on one device (``impl="ep"`` and ``"dense"`` alike):
    ``moe_dense``'s function, reading only the chosen experts' weights.

    One host sync a call (the per-expert token counts).
    """
    m = cfg.moe
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    w, ids = _routing(p, cfg, x2d)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    tok = order // m.top_k
    gate = w.reshape(-1)[order]
    counts = torch.bincount(flat, minlength=m.n_experts).tolist()
    y = torch.zeros((x2d.shape[0], d), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        t_e = tok[start:start + n]
        xe = x2d[t_e]
        act = F.silu(xe @ p["w_gate"][e]) * (xe @ p["w_up"][e])
        # index_add_'s sum; index_put_ takes ~1000x less time on the CPU here
        y.index_put_((t_e,), (act @ p["w_down"][e]).float() * gate[start:start + n, None],
                     accumulate=True)
        start += n
    y = y.to(x.dtype)
    if m.n_shared > 0:
        y = y + mlp(p["shared"], x2d)
    return y.reshape(B, S, d)
