"""Dense decoder with grouped-query attention (StableLM-2 as the port runs
it: RMSNorm, rotary over every head dim, no projection bias, SiLU-gated
MLP), in float32."""

from __future__ import annotations

import torch

from .common import causal_attention, gated_mlp, head, layers, linear, rmsnorm, rope

__all__ = ["hidden", "head", "PORT_WIDTHS", "matrix_params", "attention_dims"]

#: (file key, the port's ``ModelConfig`` attribute) of every width the
#: file states: a run stops before it starts where the port's differ
PORT_WIDTHS = [
    ("hidden_size", "d_model"), ("intermediate_size", "d_ff"),
    ("num_attention_heads", "n_heads"), ("num_key_value_heads", "n_kv_heads"),
    ("num_hidden_layers", "n_layers"), ("vocab_size", "vocab"),
    ("rope_theta", "rope_theta"), ("layer_norm_eps", "norm_eps"),
    ("tie_word_embeddings", "tie_embeddings"), ("use_qkv_bias", "qkv_bias"),
]


def attention_dims(cfg: dict):
    """(layers, heads, d_qk, d_v)."""
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    return cfg["num_hidden_layers"], cfg["num_attention_heads"], hd, hd


def matrix_params(cfg: dict) -> int:
    """Matrix parameters one token multiplies through (LM head included)."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // H
    attn = d * H * hd + 2 * d * K * hd + H * hd * d
    return L * (attn + 3 * d * cfg["intermediate_size"]) + d * cfg["vocab_size"]


def hidden(w: dict, cfg: dict, tokens: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    """Final-norm hidden states ``(S, d)`` of a causal forward over
    ``tokens`` ``(S,)`` from position 0."""
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    K = cfg["num_key_value_heads"]
    hd = d // H
    eps = cfg["layer_norm_eps"]
    theta = float(cfg["rope_theta"])
    S = tokens.shape[0]
    x = w["embedding"][tokens.long()].float()
    for lw in layers(w):
        a = lw["attn"]
        h = rmsnorm(x, lw["norm1"], eps)
        q = rope(linear(h, a["wq"], mode).view(S, H, hd), theta)
        k = rope(linear(h, a["wk"], mode).view(S, K, hd), theta)
        v = linear(h, a["wv"], mode).view(S, K, hd)
        x = x + linear(causal_attention(q, k, v, hd ** -0.5), a["wo"], mode)
        x = x + gated_mlp(rmsnorm(x, lw["norm2"], eps), lw["mlp"], mode)
    return rmsnorm(x, w["final_norm"], eps)
