"""Model-tier cost table and the step builders.

Copy of ``repro/models/zoo.py``'s tier table (``TierSpec``,
``MODEL_TIERS``, ``resolve_tier``, ``tier_spec``, ``cost_per_token``;
prices and quality proxies are hand-set, not measured) and of its step
builders (``build_train_step``, ``build_prefill_step``,
``build_decode_step``, ``build_forward``).  JAX jits its steps; the port
runs them eagerly, and the train step's autograd reaches the flash and
RMSNorm backward kernels on the card (``repro_torch.kernels.ops``).

The logical sharding of the inputs (``input_logical``), of the decode
caches (``cache_logical``) and of the parameters (``param_specs``, the
spec tree of JAX's ``param_shapes``), which
:mod:`repro_torch.distributed.sharding` resolves on a mesh.

The dry-run shape helpers (``input_specs``, ``param_shapes``,
``opt_state_shapes``) stand in for JAX's ``ShapeDtypeStruct`` trees with
tensors on the ``meta`` device: shapes and dtypes, nothing allocated.
JAX's dtypes map to the port's one for one: ``int32`` -> ``torch.int32``
(the tokens and ``lengths``, as the port's steps take them),
``bfloat16`` -> ``torch.bfloat16``, ``float32`` -> ``torch.float32``,
``int8`` -> ``torch.int8``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..distributed import sharding as shd
from ..distributed.optimizer import (OptConfig, adamw_update, init_opt_state, tree_leaves,
                                     tree_unflatten)
from . import transformer as T
from .config import ModelConfig, ShapeConfig


# ---------------------------------------------------------------------------
# Logical sharding of inputs, caches and parameters
# ---------------------------------------------------------------------------
def input_logical(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        out["tokens"] = ("batch", None)
        out["targets"] = ("batch", None)
    elif shape.kind == "prefill":
        out["tokens"] = ("batch", None)
    else:
        out["tokens"] = ("batch",)
        out["cache"] = "__cache__"   # resolved by cache_logical()
    if cfg.family in ("vlm", "audio") and shape.kind != "decode":
        out["enc_input"] = ("batch", None, None)
    return out


def cache_logical(cfg: ModelConfig, cache_shapes, model_axis_size: int):
    """Logical names for every cache leaf, chosen per-arch: KV heads shard
    over ``model`` when divisible, otherwise the cache sequence dim does
    (flash-decode style; the port's decode attention gathers that dim
    before its kernel)."""
    heads_divisible = model_axis_size > 0 and cfg.n_kv_heads % model_axis_size == 0
    kv_heads = "kv_heads" if heads_divisible else None
    kv_seq = None if heads_divisible else "kv_seq"

    def map_leaf(path, x):
        name = path[-1]
        nd = len(x.shape)
        if "__cross" in path:
            base = (None, "batch", None, kv_heads, None)
            return (None,) * max(0, nd - 5) + tuple(base)[-nd:]
        if name in ("k", "v"):
            base = ("batch", kv_seq, kv_heads, None)
        elif name in ("k_s", "v_s"):
            base = ("batch", kv_seq, kv_heads)
        elif name in ("c_kv", "k_rope"):
            base = ("batch", kv_seq, None)
        elif name == "lengths":
            base = ("batch",)
        elif name in ("conv", "ssm", "C", "n", "m", "c", "h"):
            base = ("batch",) + (None,) * (nd - 1)
            base = base[:nd]
        elif name in ("__cross_k", "__cross_v"):
            base = ("batch", None, kv_heads, None)
        else:
            base = (None,) * nd
        pad = nd - len(base)
        return (None,) * pad + tuple(base) if pad >= 0 else tuple(base)[-nd:]

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            # a sequence element's path entry is its index (JAX's
            # SequenceKey), which matches no leaf name
            return type(node)(walk(v, path + (f"[{i}]",)) for i, v in enumerate(node))
        return map_leaf(path, node)

    return walk(cache_shapes, ())


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameters' logical-axis tree: the spec tree of JAX's
    ``param_shapes(cfg)`` (:func:`repro_torch.models.transformer.param_specs`)."""
    return T.param_specs(cfg)


# ---------------------------------------------------------------------------
# Input, parameter and optimizer-state shapes (dry-run currency)
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` tensors in the shapes and dtypes of every input of the
    cell's step: ``tokens`` (and ``targets`` to train), a decode cell's
    empty cache (:func:`~repro_torch.models.transformer.init_cache` on
    ``meta``, ``seq_len + 8`` rounded up to a multiple of 256 so its
    sequence dim shards), and the VLM's and Whisper's
    ``enc_input`` outside decode.  Built without a mesh whatever is
    active: the caller places them."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        out["tokens"] = torch.empty((B, S), dtype=torch.int32, device=meta)
        out["targets"] = torch.empty((B, S), dtype=torch.int32, device=meta)
    elif shape.kind == "prefill":
        out["tokens"] = torch.empty((B, S), dtype=torch.int32, device=meta)
    else:  # decode: one new token against a cache of length S
        out["tokens"] = torch.empty((B,), dtype=torch.int32, device=meta)
        max_len = ((S + 8 + 255) // 256) * 256
        with shd.use_mesh(None):
            out["cache"] = T.init_cache(cfg, B, max_len, meta)
    if cfg.family in ("vlm", "audio") and shape.kind != "decode":
        out["enc_input"] = torch.empty((B, cfg.encoder.n_ctx, cfg.d_model),
                                       dtype=cfg.tdtype, device=meta)
    return out


def param_shapes(cfg: ModelConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(shape_tree, spec_tree)``: :func:`init_params` on ``meta`` and
    :func:`param_specs`; nothing is allocated."""
    return T.init_params(cfg, 0, "meta"), param_specs(cfg)


def opt_state_shapes(cfg: ModelConfig, opt_cfg: OptConfig, params_shapes) -> Dict[str, Any]:
    """:func:`~repro_torch.distributed.optimizer.init_opt_state` of
    ``params_shapes`` (``meta`` tensors) on ``meta``: float32 ``m``/``v``,
    or int8 codes beside float32 row scales."""
    return init_opt_state(params_shapes, opt_cfg)


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

    On DTensor params (under ``sharding.use_mesh``) each gradient is a
    DTensor placed as its parameter: a gradient that autograd leaves
    ``Partial`` (a replicated parameter's, summed over the rows' shards)
    is reduced here, as JAX's ``jit`` reduces it.
    """
    flat = tree_leaves(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = T.lm_loss(tree_unflatten(params, leaves), cfg, batch["tokens"],
                         batch["targets"], enc_input=batch.get("enc_input"))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _placed_as(g, p)
             for p, g in zip(flat, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if shd.is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


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
