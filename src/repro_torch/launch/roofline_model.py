"""Analytic FLOP/byte accounting per (architecture × shape): the
compute and memory roofline terms.

Copy of ``repro/launch/roofline_model.py`` over the port's
``ModelConfig`` / ``ShapeConfig``, with the float operations in the same
order, so each term equals the JAX package's to the bit.  The terms are
exact transformer accounting, as there: the dry run
(:mod:`repro_torch.launch.dryrun`) traces each cell for its collectives
and argument bytes, and takes compute and memory from here.
"""

from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig, ShapeConfig


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    return sum(
        1
        for i in range(cfg.n_layers)
        if cfg.is_attn_layer(i) and not cfg.is_cross_layer(i)
    )


def _cross_layers(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.n_layers) if cfg.is_cross_layer(i))


def analytic_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Whole-step (global) FLOPs.

    Matmul term: 2 FLOPs/param/token over *active* non-embedding params +
    the LM head.  Attention score term: 4·ctx·H·hd per attn layer per
    token (÷2 for the causal triangle during full-seq passes).  Train
    multiplies by 3 (fwd+bwd) + 1 extra fwd when remat=full.
    """
    total, active = cfg.param_count()
    d, V = cfg.d_model, cfg.vocab
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    mat_params = max(0, active - emb)          # matmul-visible params
    H, hd = cfg.n_heads, cfg.hd
    B, S = shape.global_batch, shape.seq_len
    La = _attn_layers(cfg) + _cross_layers(cfg)

    if shape.kind in ("train", "prefill"):
        tokens = B * S
        mat = 2.0 * mat_params * tokens + 2.0 * d * V * tokens  # + head
        attn = 4.0 * (S / 2) * H * hd * La * tokens             # causal avg ctx
        fwd = mat + attn
        if shape.kind == "prefill":
            return fwd
        mult = 3.0 + (1.0 if cfg.remat == "full" else 0.0)
        return mult * fwd
    # decode: 1 token/request against a ctx of S
    tokens = B
    mat = 2.0 * mat_params * tokens + 2.0 * d * V * tokens
    attn = 4.0 * S * H * hd * La * tokens
    return mat + attn


def analytic_bytes(cfg: ModelConfig, shape: ShapeConfig,
                   opt_state_bytes_per_param: float = 2.0) -> float:
    """Whole-step (global) HBM traffic estimate.

    - weights: streamed once per pass (fwd, bwd, remat-fwd); grads written
      +read, optimizer state read+write (int8 m/v default = 2 B/param);
    - activations: ~12 intermediate tensors of (tokens × d) per layer per
      pass at 2 B (bf16), halved by fusion;
    - logits: (tokens × V) in f32 for the loss (train) / bf16 (serve);
    - decode: weights once + the KV cache read for every request.
    """
    total, active = cfg.param_count()
    d, V = cfg.d_model, cfg.vocab
    B, S = shape.global_batch, shape.seq_len
    L = cfg.n_layers
    wb = 2.0  # bf16 weights

    if shape.kind == "train":
        tokens = B * S
        passes = 3.0 if cfg.remat == "full" else 2.0
        weights = active * wb * passes               # fwd + bwd (+ remat fwd)
        grads = 2.0 * active * wb                    # write + read
        opt = active * (2.0 * opt_state_bytes_per_param + 2.0 * wb)
        acts = 6.0 * L * tokens * d * 2.0 * 2.0      # fwd+bwd, fused estimate
        logits = tokens * V * (4.0 + 4.0)            # f32 fwd + bwd
        return weights + grads + opt + acts + logits
    if shape.kind == "prefill":
        tokens = B * S
        weights = active * wb
        acts = 6.0 * L * tokens * d * 2.0
        kv_write = tokens * cfg.kv_bytes_per_token()
        return weights + acts + kv_write
    # decode
    weights = active * wb
    kv_read = B * S * cfg.kv_bytes_per_token()
    acts = 12.0 * L * B * d * 2.0
    logits = B * V * 2.0
    return weights + kv_read + acts + logits


def analytic_terms(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
                   peak_flops: float, hbm_bw: float) -> Dict[str, float]:
    return {
        "compute_s": analytic_flops(cfg, shape) / (n_chips * peak_flops),
        "memory_s": analytic_bytes(cfg, shape) / (n_chips * hbm_bw),
    }
