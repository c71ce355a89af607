"""DeepSeek-V2 decoder as the port runs it, in float32: multi-head latent
attention without absorption (per-head keys and values expanded from the
512-wide latent, a 64-wide rotary key shared by every head, softmax
scale (nope + rope)^-1/2), a leading dense SiLU-gated MLP, then layers of
softmax routing over the routed experts (top-k, gates renormalised to sum
to one, as ``norm_topk_prob`` in the file states) plus the shared
experts, one gated MLP of ``n_shared * moe_intermediate_size``."""

from __future__ import annotations

import torch

from .common import causal_attention, gated_mlp, head, layers, linear, rmsnorm, rope

__all__ = ["hidden", "head", "PORT_WIDTHS", "matrix_params", "attention_dims"]

#: (file key, the port's ``ModelConfig`` attribute path) of every width the
#: file states: a run stops before it starts where the port's differ
PORT_WIDTHS = [
    ("hidden_size", "d_model"), ("num_attention_heads", "n_heads"),
    ("num_hidden_layers", "n_layers"), ("vocab_size", "vocab"),
    ("kv_lora_rank", "mla.kv_lora_rank"), ("qk_rope_head_dim", "mla.rope_head_dim"),
    ("qk_nope_head_dim", "mla.nope_head_dim"), ("v_head_dim", "mla.v_head_dim"),
    ("n_routed_experts", "moe.n_experts"), ("num_experts_per_tok", "moe.top_k"),
    ("moe_intermediate_size", "moe.d_ff_expert"), ("n_shared_experts", "moe.n_shared"),
    ("first_k_dense_replace", "moe.first_dense"), ("intermediate_size", "moe.d_ff_dense"),
    ("rms_norm_eps", "norm_eps"), ("rope_theta", "rope_theta"),
    ("tie_word_embeddings", "tie_embeddings"),
]


def attention_dims(cfg: dict):
    """(layers, heads, d_qk, d_v)."""
    return (cfg["num_hidden_layers"], cfg["num_attention_heads"],
            cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def matrix_params(cfg: dict) -> int:
    """Matrix parameters one token multiplies through: MLA's projections
    (keys and values expanded from the latent), the dense layers' MLP,
    the router, the chosen and the shared experts, the LM head."""
    d, H, L = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_hidden_layers"]
    nope, rope_d, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    lora = cfg["kv_lora_rank"]
    attn = d * H * (nope + rope_d) + d * (lora + rope_d) + lora * H * (nope + vd) + H * vd * d
    dense = cfg["first_k_dense_replace"]
    f = cfg["moe_intermediate_size"]
    moe = d * cfg["n_routed_experts"] + (cfg["num_experts_per_tok"]
                                         + cfg["n_shared_experts"]) * 3 * d * f
    return (L * attn + dense * 3 * d * cfg["intermediate_size"]
            + (L - dense) * moe + d * cfg["vocab_size"])


def _mla(a: dict, cfg: dict, h: torch.Tensor, mode: str) -> torch.Tensor:
    S = h.shape[0]
    H = cfg["num_attention_heads"]
    nope, rdim = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vdim, lora = cfg["v_head_dim"], cfg["kv_lora_rank"]
    theta = float(cfg["rope_theta"])
    q = linear(h, a["wq"], mode).view(S, H, nope + rdim)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    dkv = linear(h, a["w_dkv"], mode)
    c_kv = dkv[:, :lora]
    k_rope = rope(dkv[:, None, lora:], theta)                      # (S, 1, rdim)
    k_nope = linear(c_kv, a["w_uk"], mode).view(S, H, nope)
    v = linear(c_kv, a["w_uv"], mode).view(S, H, vdim)
    k = torch.cat([k_nope, k_rope.expand(S, H, rdim)], dim=-1)
    out = causal_attention(q, k, v, (nope + rdim) ** -0.5)
    return linear(out, a["wo"], mode)


def _moe(m: dict, cfg: dict, h: torch.Tensor, mode: str) -> torch.Tensor:
    top_k = cfg["num_experts_per_tok"]
    probs = torch.softmax(linear(h, m["router"], mode), dim=-1)
    gate, ids = torch.topk(probs, top_k, dim=-1)
    if cfg["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in torch.unique(ids).tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        xe = h[tok]
        act = torch.nn.functional.silu(linear(xe, m["w_gate"][e], mode)) * linear(
            xe, m["w_up"][e], mode)
        y.index_add_(0, tok, linear(act, m["w_down"][e], mode) * gate[tok, slot, None])
    y = y * cfg.get("routed_scaling_factor", 1)
    if cfg.get("n_shared_experts", 0):
        y = y + gated_mlp(h, m["shared"], mode)
    return y


def hidden(w: dict, cfg: dict, tokens: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    """Final-norm hidden states ``(S, d)`` of a causal forward over
    ``tokens`` ``(S,)`` from position 0."""
    eps = cfg["rms_norm_eps"]
    x = w["embedding"][tokens.long()].float()
    for lw in layers(w):
        x = x + _mla(lw["attn"], cfg, rmsnorm(x, lw["norm1"], eps), mode)
        h = rmsnorm(x, lw["norm2"], eps)
        x = x + (_moe(lw["moe"], cfg, h, mode) if "moe" in lw
                 else gated_mlp(h, lw["mlp"], mode))
    return rmsnorm(x, w["final_norm"], eps)
