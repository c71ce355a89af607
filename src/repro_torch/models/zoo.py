"""Model-tier cost table: the cascade routing currency of the fleet.

Copy of the tier table of ``repro/models/zoo.py`` (``TierSpec``,
``MODEL_TIERS``, ``resolve_tier``, ``tier_spec``, ``cost_per_token``);
the rest of that module (jitted train/serve steps) is JAX and is not
ported here.  Prices and quality proxies are hand-set, not measured.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


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
#: (``repro_torch.configs.ARCH_IDS`` lists the ported ones).
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
