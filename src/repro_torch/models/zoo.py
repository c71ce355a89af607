"""Model-tier cost table and the step builders.

Copy of ``repro/models/zoo.py``'s tier table (``TierSpec``,
``MODEL_TIERS``, ``resolve_tier``, ``tier_spec``, ``cost_per_token``;
prices and quality proxies are hand-set, not measured) and of its step
builders (``build_train_step``, ``build_prefill_step``,
``build_decode_step``, ``build_forward``).  JAX jits its steps; the port
runs them eagerly, and the train step's autograd reaches the flash and
RMSNorm backward kernels on the card (``repro_torch.kernels.ops``).  The
dry-run shape helpers (``input_specs``, ``param_shapes``,
``opt_state_shapes``) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..distributed.optimizer import OptConfig, adamw_update, tree_leaves, tree_unflatten
from . import transformer as T
from .config import ModelConfig


@dataclass(frozen=True)
class TierSpec:
    """Serving economics of one zoo architecture.

    Attributes
    ----------
    usd_per_mtok : float
        Serving price in $ per million *generated* tokens.  Hand-set to
        API-price-like values, monotone in active parameter count
        within a family (MoE models price by *active* params — Kimi-K2
        at 32B active undercuts dense Llama-405B despite more total
        weight).
    quality : float
        Task-success proxy in [0, 1]: the probability mass of stage
        difficulties this tier clears a quality gate on (see
        :mod:`repro_torch.core.cascade`).  Monotone in price.
    latency_scale : float
        Per-token decode latency multiplier relative to the simulator's
        baseline ``l(b)`` model (1.0 = baseline; cheap tiers decode
        faster, giant tiers slower).
    """

    usd_per_mtok: float
    quality: float
    latency_scale: float


#: Per-architecture tier economics, keyed by the registry arch id
#: (``repro_torch.configs.ARCH_IDS``).
MODEL_TIERS: Dict[str, TierSpec] = {
    "whisper_tiny":         TierSpec(0.05, 0.30, 0.45),
    "xlstm_350m":           TierSpec(0.06, 0.35, 0.50),
    "stablelm_1_6b":        TierSpec(0.10, 0.45, 0.60),
    "deepseek_v2_lite_16b": TierSpec(0.28, 0.60, 0.75),
    "internlm2_20b":        TierSpec(0.35, 0.62, 0.80),
    "llama3_2_vision_90b":  TierSpec(1.20, 0.78, 1.15),
    "qwen1_5_110b":         TierSpec(1.40, 0.80, 1.20),
    "jamba_1_5_large_398b": TierSpec(2.20, 0.86, 1.25),
    "kimi_k2_1t_a32b":      TierSpec(2.40, 0.96, 1.30),
    "llama3_405b":          TierSpec(3.50, 0.90, 1.60),
}

#: Every non-arch-id spelling a ``ModelConfig.name`` or CLI alias can
#: carry, mapped to its arch id — explicit, so resolution never guesses.
_TIER_ALIASES: Dict[str, str] = {
    # published config names
    "stablelm-1.6b": "stablelm_1_6b",
    "internlm2-20b": "internlm2_20b",
    "qwen1.5-110b": "qwen1_5_110b",
    "llama3-405b": "llama3_405b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-tiny": "whisper_tiny",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "xlstm-350m": "xlstm_350m",
    # smoke-config names (same family → same tier economics, so CPU
    # testbeds exercise real heterogeneous routing)
    "stablelm-smoke": "stablelm_1_6b",
    "internlm2-smoke": "internlm2_20b",
    "qwen-smoke": "qwen1_5_110b",
    "llama3-smoke": "llama3_405b",
    "vision-smoke": "llama3_2_vision_90b",
    "jamba-smoke": "jamba_1_5_large_398b",
    "whisper-smoke": "whisper_tiny",
    "kimi-smoke": "kimi_k2_1t_a32b",
    "deepseek-smoke": "deepseek_v2_lite_16b",
    "xlstm-smoke": "xlstm_350m",
}


def resolve_tier(name: str) -> Optional[str]:
    """Map any known model spelling to its tier-table arch id.

    Parameters
    ----------
    name : str
        A registry arch id, a published ``ModelConfig.name``, a smoke-
        config name, or a CLI alias.

    Returns
    -------
    str or None
        The ``MODEL_TIERS`` key, or ``None`` for unknown models (e.g.
        ad-hoc test configs) — callers must gate the cost signal off
        rather than invent a price.
    """
    key = name.strip().lower()
    if key in MODEL_TIERS:
        return key
    return _TIER_ALIASES.get(key)


def tier_spec(name: str) -> Optional[TierSpec]:
    """Return the :class:`TierSpec` for any known model spelling.

    Parameters
    ----------
    name : str
        Any spelling :func:`resolve_tier` accepts.

    Returns
    -------
    TierSpec or None
        The tier economics, or ``None`` for unknown models.
    """
    arch = resolve_tier(name)
    return MODEL_TIERS[arch] if arch is not None else None


def cost_per_token(name: str) -> Optional[float]:
    """Return the serving cost of one generated token, in $.

    Parameters
    ----------
    name : str
        Any spelling :func:`resolve_tier` accepts.

    Returns
    -------
    float or None
        ``usd_per_mtok / 1e6``, or ``None`` for unknown models.
    """
    spec = tier_spec(name)
    return spec.usd_per_mtok / 1e6 if spec is not None else None


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------
def loss_and_grads(params: Dict[str, Any], cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``jax.value_and_grad`` of :func:`~repro_torch.models.transformer.lm_loss`
    at ``params``: ``(loss, grads)``, grads a tree shaped as params.

    The loss is taken at aliases of the leaves that require grad
    (``detach().requires_grad_()``: the same storage, the caller's tensors
    untouched), so the gradients of a stacked leaf's per-layer views sum
    into that leaf.  A leaf the loss does not use gets zeros, as JAX gives
    it.  The graph, the float32 logits' gradient included, is freed before
    this returns.
    """
    flat = tree_leaves(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = T.lm_loss(tree_unflatten(params, leaves), cfg, batch["tokens"],
                         batch["targets"], enc_input=batch.get("enc_input"))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def build_train_step(cfg: ModelConfig, opt_cfg: Optional[OptConfig] = None):
    """``train_step(params, opt_state, batch) -> (new_params, new_state,
    metrics{"loss", "grad_norm", "lr"})``.

    ``batch`` holds ``tokens`` and ``targets`` (and ``enc_input`` for the
    VLM and Whisper).  The update is in place (JAX donates both trees):
    the returned trees hold the caller's tensors.
    """
    opt_cfg = opt_cfg or OptConfig()

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch)
        new_params, new_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return train_step


def build_prefill_step(cfg: ModelConfig, max_len: Optional[int] = None):
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        ml = max_len or (tokens.shape[1] + 8)
        return T.prefill(params, cfg, tokens, max_len=ml,
                         enc_input=batch.get("enc_input"))

    return prefill_step


def build_decode_step(cfg: ModelConfig):
    def serve_step(params, batch):
        return T.decode_step(params, cfg, batch["cache"], batch["tokens"])

    return serve_step


def build_forward(cfg: ModelConfig):
    def fwd(params, batch):
        logits, _ = T.forward(params, cfg, batch["tokens"],
                              enc_input=batch.get("enc_input"))
        return logits

    return fwd
