"""Decoder layout and weights of the dense family (the paged path's subset).

From ``repro/models/transformer.py``: the layer-kind and superblock
layout (``layer_kind``, ``superblock_len``, ``_scan_layout``), the FFN
half of a layer (``_apply_ffn``, ``mlp`` branch) and ``init_params``
for the dense family.  Parameters form the same tree as the JAX
package's: ``embedding``, ``lm_head``, ``final_norm`` and
``blocks[str(j)]`` with every leaf stacked over superblocks on axis 0.
The other families, mixers and the slot-cache forward passes are not
ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..device import DeviceLike, resolve_device
from . import layers as L
from .config import ModelConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Layer kinds
# ---------------------------------------------------------------------------
def layer_kind(cfg: ModelConfig, i: int) -> str:
    """What lives at absolute layer index i."""
    if cfg.family == "ssm":
        x = cfg.xlstm
        cell = "slstm" if (i % x.slstm_every) == (x.slstm_every - 1) else "mlstm"
        return f"{cell}+none"
    mixer = "attn"
    if cfg.mla is not None:
        mixer = "mla"
    if cfg.mamba is not None and not cfg.is_attn_layer(i):
        mixer = "mamba"
    if cfg.is_cross_layer(i):
        mixer = "cross"
    ffn = "mlp"
    if cfg.is_moe_layer(i):
        ffn = "moe"
    elif cfg.moe is not None and i < cfg.moe.first_dense:
        ffn = "dense_mlp"
    elif cfg.d_ff == 0:
        ffn = "none"
    return f"{mixer}+{ffn}"


def superblock_len(cfg: ModelConfig) -> int:
    periods = [1]
    if cfg.family == "ssm":
        periods.append(cfg.xlstm.slstm_every)
    if cfg.attn_period > 1:
        periods.append(cfg.attn_period)
    if cfg.cross_attn_period > 0:
        periods.append(cfg.cross_attn_period)
    if cfg.moe is not None and cfg.moe.layer_period > 1:
        periods.append(cfg.moe.layer_period)
    return int(math.lcm(*periods))


def _scan_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_prefix, pattern_len, n_superblocks): prefix layers are unstacked
    (e.g. DeepSeek's leading dense layer)."""
    n_prefix = cfg.moe.first_dense if cfg.moe is not None else 0
    pat = superblock_len(cfg)
    rest = cfg.n_layers - n_prefix
    if rest % pat:
        # pattern does not tile the remaining depth: unstacked prefix only
        return cfg.n_layers, 1, 0
    return n_prefix, pat, rest // pat


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(init: L.Init, cfg: ModelConfig, kind: str, lead: Tuple[int, ...]) -> Params:
    mixer, ffn = kind.split("+")
    if mixer != "attn" or ffn not in ("mlp", "none"):
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP queue 1, "
            "remaining architectures)"
        )
    p: Params = {"norm1": L.init_rmsnorm(init, cfg.d_model, lead),
                 "attn": L.init_attention(init, cfg, lead)}
    if ffn == "mlp":
        p["norm2"] = L.init_rmsnorm(init, cfg.d_model, lead)
        p["mlp"] = L.init_mlp(init, cfg.d_model, cfg.d_ff, lead)
    return p


def init_params(cfg: ModelConfig, seed: int, device: DeviceLike = None) -> Params:
    """Random weights of a dense decoder, drawn on ``device``.

    Parameters
    ----------
    cfg : ModelConfig
        A ``family="dense"`` config.
    seed : int
        Seed of the ``torch.Generator`` the weights are drawn from.
    device : str or torch.device, optional
        Where to draw and keep the weights; ``None`` means the CUDA
        device (and raises without one).

    Returns
    -------
    dict
        The parameter tree (the JAX package also returns sharding specs;
        the port has none yet).
    """
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            "remaining architectures)"
        )
    init = L.Init(seed, cfg.tdtype, resolve_device(device))
    params: Params = L.init_embed(init, cfg)
    params["final_norm"] = L.init_rmsnorm(init, cfg.d_model)
    n_prefix, pat, n_sb = _scan_layout(cfg)
    if n_prefix or n_sb == 0:
        raise NotImplementedError("unstacked prefix layers are not ported yet")
    params["blocks"] = {
        str(j): _init_layer(init, cfg, layer_kind(cfg, j), (n_sb,))
        for j in range(pat)
    }
    return params


# ---------------------------------------------------------------------------
# forward building blocks
# ---------------------------------------------------------------------------
def _apply_ffn(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm FFN with residual (the JAX version's ``decoding`` switch
    selects a sharded decode MLP, which is not ported)."""
    _, ffn = kind.split("+")
    if ffn == "none":
        return x
    if ffn not in ("mlp", "dense_mlp"):
        raise NotImplementedError(f"ffn {ffn!r} is not ported yet")
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h)
