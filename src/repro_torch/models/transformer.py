"""Decoder layout, weights and slot-cache forward passes of the dense family.

From ``repro/models/transformer.py``: the layer-kind and superblock
layout (``layer_kind``, ``superblock_len``, ``_scan_layout``),
``init_params`` for the dense family, the attention + MLP layer in its
full-sequence and decode forms (``_apply_layer_full``,
``_apply_layer_decode``, ``_apply_ffn``), ``forward``, and the slot
engine's cache functions ``init_cache``, ``prefill`` and
``decode_step``.  Parameters and caches form the same trees as the JAX
package's: ``embedding``, ``lm_head``, ``final_norm`` and
``blocks[str(j)]`` with every leaf stacked over superblocks on axis 0.
With ``kv_cache_dtype="int8"`` the slot cache holds int8 K/V and float32
scales ``k_s``/``v_s`` ``(n_sb, B, max_len, K)``, as in the JAX package.

In PyTorch's idiom, the ``lax.scan`` over superblocks is a Python loop
over per-layer views, and ``decode_step`` writes the new K/V into the
cache **in place** (it still returns the cache, with ``lengths`` a new
tensor).  The other families and mixers (MLA, Mamba, xLSTM, cross
attention) are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..kernels import ops
from . import layers as L
from .config import ModelConfig

Params = Dict[str, Any]

NOT_PORTED = "is not ported yet (ROADMAP queue 1, remaining architectures)"


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
        raise NotImplementedError(f"layer kind {kind!r} {NOT_PORTED}")
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
        raise NotImplementedError(f"family {cfg.family!r} {NOT_PORTED}")
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


def _layer_views(tree: Dict[str, Any], s: int) -> Dict[str, Any]:
    """Superblock ``s`` of a tree stacked on axis 0 (views, no copies)."""
    return {
        k: _layer_views(v, s) if isinstance(v, dict) else v[s]
        for k, v in tree.items()
    }


def _check_slot_path(cfg: ModelConfig) -> Tuple[int, int]:
    """(pattern length, superblocks) of a config the slot path supports.

    Every slot-path entry point calls this first, so the layer functions
    below may assume dense attention layers.
    """
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} {NOT_PORTED}")
    n_prefix, pat, n_sb = _scan_layout(cfg)
    if n_prefix or n_sb == 0:
        raise NotImplementedError("unstacked prefix layers are not ported yet")
    for j in range(pat):
        kind = layer_kind(cfg, j)
        if kind.split("+")[0] != "attn":
            raise NotImplementedError(f"layer kind {kind!r} {NOT_PORTED}")
    return pat, n_sb


def _apply_layer_full(
    p: Params,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention + FFN layer; returns (x, {"k", "v"})."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    out, kv = L.attention_full(p["attn"], cfg, h, positions, causal=causal)
    x = _apply_ffn(p, cfg, kind, x + out)
    return x, kv


def _apply_layer_decode(
    p: Params,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    lengths: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token attention + FFN layer over a slot cache (written in place)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.kv_cache_dtype == "int8":
        out, new_cache = L.attention_decode_q8(p["attn"], cfg, h, cache, lengths)
    else:
        out, ck, cv = L.attention_decode(p["attn"], cfg, h, cache["k"], cache["v"],
                                         lengths)
        new_cache = {"k": ck, "v": cv}
    x = _apply_ffn(p, cfg, kind, x + out)
    return x, new_cache


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------
def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                    # (B, S) int
    collect_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (logits (B, S, V), cache or None).

    With ``collect_cache`` the cache is ``{"blocks": {j: {"k", "v"}}}``,
    each ``(n_sb, B, S, K, hd)``: the K/V of every layer, stacked over
    superblocks as the JAX scan stacks them.
    """
    pat, n_sb = _check_slot_path(cfg)
    B, Sq = tokens.shape
    x = L.embed(params, tokens).to(cfg.tdtype)
    positions = torch.arange(Sq, device=tokens.device)[None].expand(B, Sq)
    kinds = [layer_kind(cfg, j) for j in range(pat)]
    kvs: Dict[str, Dict[str, list]] = {str(j): {"k": [], "v": []} for j in range(pat)}
    for s in range(n_sb):
        for j in range(pat):
            p = _layer_views(params["blocks"][str(j)], s)
            x, kv = _apply_layer_full(p, cfg, kinds[j], x, positions)
            if collect_cache:
                kvs[str(j)]["k"].append(kv["k"])
                kvs[str(j)]["v"].append(kv["v"])
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params, x, cfg.tie_embeddings)
    if not collect_cache:
        return logits, None
    blocks = {j: {n: torch.stack(c[n]) for n in ("k", "v")} for j, c in kvs.items()}
    return logits, {"blocks": blocks}


# ---------------------------------------------------------------------------
# slot KV cache: allocation, prefill, decode
# ---------------------------------------------------------------------------
def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Empty slot caches: ``{"lengths": (B,) int32, "blocks": {j: {"k", "v"}}}``.

    Each ``k``/``v`` is ``(n_sb, B, max_len, K, hd)`` in the model's
    compute dtype, zero-filled, on ``device`` (``None`` means the CUDA
    device).  With ``kv_cache_dtype="int8"`` they are int8 zeros, beside
    float32 scales ``k_s``/``v_s`` ``(n_sb, B, max_len, K)`` that start
    at **zero** (the paged pools' scales start at one).
    """
    pat, n_sb = _check_slot_path(cfg)
    dev = resolve_device(device)
    shape = (n_sb, batch, max_len, cfg.n_kv_heads, cfg.hd)

    def attn_cache() -> Dict[str, torch.Tensor]:
        if cfg.kv_cache_dtype == "int8":
            return {
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                "v_s": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            }
        return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.tdtype, device=dev)}

    return {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "blocks": {str(j): attn_cache() for j in range(pat)},
    }


def prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                    # (B, S) int
    max_len: int,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt, build the decode cache.  Returns (last_logits, cache).

    On an int8 cache the prompt's K/V are quantized as they are placed
    (JAX's ``place_attn_q8``).
    """
    B, Sq = tokens.shape
    logits, run_cache = forward(params, cfg, tokens, collect_cache=True)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    cache["lengths"].fill_(Sq)
    for j, blk in run_cache["blocks"].items():
        dst = cache["blocks"][j]
        for name in ("k", "v"):
            src = blk[name]
            if cfg.kv_cache_dtype == "int8":
                src, sc = ops.quantize_kv(src)
                dst[name + "_s"][:, :, :Sq] = sc
            dst[name][:, :, :Sq] = src.to(dst[name].dtype)
    return logits[:, -1], cache


def decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: Dict[str, Any],
    tokens: torch.Tensor,                    # (B,) or (B, 1) int
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for the whole batch; returns (logits (B, V), cache).

    The K/V caches are written in place; the returned dict is ``cache``
    with ``lengths`` replaced by ``lengths + 1``.
    """
    pat, n_sb = _check_slot_path(cfg)
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    lengths = cache["lengths"]
    x = L.embed(params, tokens).to(cfg.tdtype)
    kinds = [layer_kind(cfg, j) for j in range(pat)]
    for s in range(n_sb):
        for j in range(pat):
            p = _layer_views(params["blocks"][str(j)], s)
            c = _layer_views(cache["blocks"][str(j)], s)
            x, _ = _apply_layer_decode(p, cfg, kinds[j], x, c, lengths)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params, x, cfg.tie_embeddings)
    cache["lengths"] = lengths + 1
    return logits[:, 0], cache
