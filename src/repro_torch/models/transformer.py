"""Decoder layout, weights and slot-cache forward passes (dense and hybrid).

From ``repro/models/transformer.py``: the layer-kind and superblock
layout (``layer_kind``, ``superblock_len``, ``_scan_layout``),
``init_params``, the layer in its full-sequence and decode forms
(``_apply_layer_full``, ``_apply_layer_decode``, ``_apply_ffn``),
``forward``, and the slot engine's cache functions ``init_cache``,
``prefill`` and ``decode_step``.  A layer's mixer is GQA attention,
DeepSeek's multi-head latent attention (MLA) or Mamba (:mod:`.ssm`), its
FFN a gated MLP (a leading ``dense_mlp`` layer of an MoE model included)
or a mixture of experts with optional shared experts (:mod:`.moe`): the
dense, MoE and hybrid (Jamba) families.

Parameters and caches form the same trees as the JAX package's:
``embedding``, ``lm_head``, ``final_norm``, unstacked prefix layers
``prefix_{i}`` (every layer, when the pattern does not tile the depth)
and ``blocks[str(j)]`` with every leaf stacked over superblocks on axis
0.  An attention layer's slot cache is ``{"k", "v"}`` ``(B, max_len, K,
hd)`` (int8 K/V beside float32 scales ``k_s``/``v_s`` with
``kv_cache_dtype="int8"``), an MLA layer's the compressed latent
``{"c_kv": (B, max_len, kv_lora_rank), "k_rope": (B, max_len,
rope_head_dim)}`` in the compute dtype (whatever ``kv_cache_dtype``), a
Mamba layer's ``{"conv", "ssm"}``; in ``blocks`` each gains a leading
superblock axis.

In PyTorch's idiom, the ``lax.scan`` over superblocks is a Python loop
over per-layer views, and ``decode_step`` writes the new K/V, latents
and Mamba states into the cache **in place** (it still returns the
cache, with ``lengths`` a new tensor).  MLA decodes in the latent space
(``_mla_decode_absorbed``, plain PyTorch as in the JAX package).  The
other mixers (cross attention, mLSTM, sLSTM) and the encoder are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..kernels import ops
from . import layers as L
from . import moe as M
from . import ssm as S
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
MIXERS = ("attn", "mla", "mamba")
FFNS = ("mlp", "dense_mlp", "moe", "none")


def _check_layers(cfg: ModelConfig) -> Tuple[int, int, int]:
    """The scan layout of a config whose every layer the port runs.

    Every entry point calls this first, so the layer functions below may
    assume attention, MLA or Mamba mixers and MLP or MoE FFNs.
    """
    if cfg.encoder is not None or cfg.family == "audio":
        raise NotImplementedError(f"family {cfg.family!r} {NOT_PORTED}")
    for i in range(cfg.n_layers):
        mixer, ffn = layer_kind(cfg, i).split("+")
        if mixer not in MIXERS or ffn not in FFNS:
            raise NotImplementedError(f"layer kind {layer_kind(cfg, i)!r} {NOT_PORTED}")
    return _scan_layout(cfg)


def _init_layer(init: L.Init, cfg: ModelConfig, kind: str, lead: Tuple[int, ...]) -> Params:
    mixer, ffn = kind.split("+")
    p: Params = {"norm1": L.init_rmsnorm(init, cfg.d_model, lead)}
    if mixer == "attn":
        p["attn"] = L.init_attention(init, cfg, lead)
    elif mixer == "mla":
        p["attn"] = L.init_mla(init, cfg, lead)
    else:
        p["mamba"] = S.init_mamba(init, cfg, lead)
    if ffn != "none":
        p["norm2"] = L.init_rmsnorm(init, cfg.d_model, lead)
    if ffn == "mlp":
        p["mlp"] = L.init_mlp(init, cfg.d_model, cfg.d_ff, lead)
    elif ffn == "dense_mlp":
        p["mlp"] = L.init_mlp(init, cfg.d_model, cfg.moe.d_ff_dense or cfg.d_ff, lead)
    elif ffn == "moe":
        p["moe"] = M.init_moe(init, cfg, lead)
    return p


def init_params(cfg: ModelConfig, seed: int, device: DeviceLike = None) -> Params:
    """Random weights of a dense or hybrid decoder, drawn on ``device``.

    Parameters
    ----------
    cfg : ModelConfig
        A config whose layers are attention, MLA or Mamba mixers with MLP
        or MoE FFNs.
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
    n_prefix, pat, n_sb = _check_layers(cfg)
    init = L.Init(seed, cfg.tdtype, resolve_device(device))
    params: Params = L.init_embed(init, cfg)
    params["final_norm"] = L.init_rmsnorm(init, cfg.d_model)
    for i in range(n_prefix):
        params[f"prefix_{i}"] = _init_layer(init, cfg, layer_kind(cfg, i), ())
    if n_sb > 0:
        params["blocks"] = {
            str(j): _init_layer(init, cfg, layer_kind(cfg, n_prefix + j), (n_sb,))
            for j in range(pat)
        }
    return params


# ---------------------------------------------------------------------------
# forward building blocks
# ---------------------------------------------------------------------------
def _apply_ffn(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm FFN with residual: a gated MLP (``mlp``, ``dense_mlp``) or
    the MoE block (the JAX version's ``decoding`` switch selects a sharded
    decode MLP, which is not ported)."""
    _, ffn = kind.split("+")
    if ffn == "none":
        return x
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if ffn == "moe":
        return x + M.moe_block(p["moe"], cfg, h)
    return x + L.mlp(p["mlp"], h)


def _layer_views(tree: Dict[str, Any], s: int) -> Dict[str, Any]:
    """Superblock ``s`` of a tree stacked on axis 0 (views, no copies)."""
    return {
        k: _layer_views(v, s) if isinstance(v, dict) else v[s]
        for k, v in tree.items()
    }


def _layers(params: Params, cfg: ModelConfig, cache: Optional[Dict[str, Any]] = None):
    """Every layer in order: ``(name, kind, weights, cache)``.

    ``name`` is ``prefix_{i}`` or ``blocks/{j}`` and the weights and
    cache are the layer's own (views into the stacked trees).
    """
    n_prefix, pat, n_sb = _scan_layout(cfg)
    for i in range(n_prefix):
        key = f"prefix_{i}"
        yield key, layer_kind(cfg, i), params[key], None if cache is None else cache[key]
    kinds = [layer_kind(cfg, n_prefix + j) for j in range(pat)]
    for s in range(n_sb):
        for j in range(pat):
            c = None if cache is None else _layer_views(cache["blocks"][str(j)], s)
            yield (f"blocks/{j}", kinds[j], _layer_views(params["blocks"][str(j)], s), c)


def _apply_layer_full(
    p: Params,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence layer; returns (x, cache contribution): ``{"k", "v"}``
    of an attention layer, ``{"c_kv", "k_rope"}`` of an MLA one, the final
    ``{"conv", "ssm"}`` of a Mamba one."""
    mixer, _ = kind.split("+")
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        out, cache = L.attention_full(p["attn"], cfg, h, positions, causal=causal)
    elif mixer == "mla":
        out, cache = L.mla_full(p["attn"], cfg, h, positions)
    else:
        out, cache = S.mamba_full(p["mamba"], cfg, h)
    x = _apply_ffn(p, cfg, kind, x + out)
    return x, cache


def _apply_layer_decode(
    p: Params,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    lengths: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token layer over its slot cache, which is written in place."""
    mixer, _ = kind.split("+")
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer == "mamba":
        out, st = S.mamba_decode(p["mamba"], cfg, h, cache)
        cache["conv"].copy_(st["conv"])
        cache["ssm"].copy_(st["ssm"])
    elif mixer == "mla":
        out = _mla_decode_absorbed(p["attn"], cfg, h, cache, lengths)
    elif cfg.kv_cache_dtype == "int8":
        out, cache = L.attention_decode_q8(p["attn"], cfg, h, cache, lengths)
    else:
        out, ck, cv = L.attention_decode(p["attn"], cfg, h, cache["k"], cache["v"],
                                         lengths)
        cache = {"k": ck, "v": cv}
    x = _apply_ffn(p, cfg, kind, x + out)
    return x, cache


def _mla_decode_absorbed(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                    # (B, 1, d)
    cache: Dict[str, torch.Tensor],     # {"c_kv": (B, S_max, lora), "k_rope": (B, S_max, rope)}
    lengths: torch.Tensor,              # (B,) int32 tokens already in cache
) -> torch.Tensor:
    """MLA decode with weight absorption: attention runs in the compressed
    latent space and the per-head K/V are never built; returns the
    layer's output.

    The JAX function line for line: ``q_lat`` in the model dtype, the
    logits, mask (``arange(S_max) < lengths + 1``) and softmax in float32
    over the whole ``S_max``, the latent context through ``w_uv``, cast,
    then ``wo``.  The new latent and rope key are written **in place** at
    ``lengths[b]`` (nothing for a row at ``S_max``, as JAX's one-hot).
    """
    m = cfg.mla
    B = x.shape[0]
    h = cfg.n_heads
    q_nope, q_rope, c_kv_new, k_rope_new = L._mla_qkv(p, cfg, x, lengths[:, None])
    cache_c, cache_r = cache["c_kv"], cache["k_rope"]
    L.write_at_lengths(cache_c, c_kv_new[:, 0], lengths)
    L.write_at_lengths(cache_r, k_rope_new[:, 0], lengths)
    # absorb W_uk into q:  q' = q_nope @ W_uk^T  -> latent space
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.nope_head_dim)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], w_uk)          # (B, H, lora)
    S_max = cache_c.shape[1]
    c32 = cache_c.float()
    logits = torch.einsum("bhl,bsl->bhs", q_lat.float(), c32)
    logits = logits + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(), cache_r.float())
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    mask = torch.arange(S_max, device=x.device)[None, :] < (lengths + 1)[:, None]
    bias = torch.where(mask, 0.0, -1e30)
    w = torch.softmax(logits * scale + bias[:, None, :], dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", w, c32)                         # latent context
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhl,lhv->bhv", ctx, w_uv.float())               # (B, H, v)
    return out.reshape(B, 1, h * m.v_head_dim).to(x.dtype) @ p["wo"]


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

    With ``collect_cache`` the cache holds each layer's contribution:
    ``prefix_{i}`` as it is, and ``blocks[j]`` stacked over superblocks
    as the JAX scan stacks them (K/V ``(n_sb, B, S, K, hd)``, Mamba
    states ``(n_sb, B, ...)``).
    """
    _check_layers(cfg)
    B, Sq = tokens.shape
    x = L.embed(params, tokens).to(cfg.tdtype)
    positions = torch.arange(Sq, device=tokens.device)[None].expand(B, Sq)
    caches: Dict[str, Any] = {}
    stacked: Dict[str, list] = {}
    for name, kind, p, _ in _layers(params, cfg):
        x, c = _apply_layer_full(p, cfg, kind, x, positions)
        if not collect_cache:
            continue
        if name.startswith("prefix_"):
            caches[name] = c
        else:
            stacked.setdefault(name.split("/")[1], []).append(c)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params, x, cfg.tie_embeddings)
    if not collect_cache:
        return logits, None
    if stacked:
        caches["blocks"] = {j: {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
                            for j, cs in stacked.items()}
    return logits, caches


# ---------------------------------------------------------------------------
# slot caches: allocation, prefill, decode
# ---------------------------------------------------------------------------
def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Empty slot caches: ``{"lengths": (B,) int32, "prefix_{i}": ...,
    "blocks": {j: ...}}``, on ``device`` (``None`` means the CUDA device).

    An attention layer's ``k``/``v`` are ``(B, max_len, K, hd)`` zeros in
    the model's compute dtype, or int8 zeros beside float32 scales
    ``k_s``/``v_s`` ``(B, max_len, K)`` that start at **zero** (the paged
    pools' scales start at one) with ``kv_cache_dtype="int8"``.  An MLA
    layer's ``c_kv`` ``(B, max_len, kv_lora_rank)`` and ``k_rope`` ``(B,
    max_len, rope_head_dim)`` are zeros in the compute dtype, int8 or not
    (as in JAX).  A Mamba layer's state is zeros
    (:func:`repro_torch.models.ssm.mamba_init_state`).  Leaves under
    ``blocks`` gain a leading superblock axis.
    """
    n_prefix, pat, n_sb = _check_layers(cfg)
    dev = resolve_device(device)

    def layer_cache(kind: str, lead: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
        if kind.startswith("mamba"):
            return S.mamba_init_state(cfg, batch, cfg.tdtype, dev, lead)
        if kind.startswith("mla"):
            m = cfg.mla
            return {"c_kv": torch.zeros(lead + (batch, max_len, m.kv_lora_rank),
                                        dtype=cfg.tdtype, device=dev),
                    "k_rope": torch.zeros(lead + (batch, max_len, m.rope_head_dim),
                                          dtype=cfg.tdtype, device=dev)}
        shape = lead + (batch, max_len, cfg.n_kv_heads, cfg.hd)
        if cfg.kv_cache_dtype == "int8":
            return {
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                "v_s": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            }
        return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.tdtype, device=dev)}

    cache: Dict[str, Any] = {"lengths": torch.zeros((batch,), dtype=torch.int32,
                                                    device=dev)}
    for i in range(n_prefix):
        cache[f"prefix_{i}"] = layer_cache(layer_kind(cfg, i), ())
    if n_sb > 0:
        cache["blocks"] = {str(j): layer_cache(layer_kind(cfg, n_prefix + j), (n_sb,))
                           for j in range(pat)}
    return cache


def _place(cfg: ModelConfig, dst: Dict[str, torch.Tensor],
           src: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A prefill contribution in a fresh layer cache: the prompt's K/V in
    its first positions (quantized on an int8 cache, JAX's
    ``place_attn_q8``), an MLA layer's latents in their first positions,
    or a Mamba layer's final state in place of the initial one."""
    if "c_kv" in src:
        Sq = src["c_kv"].shape[-2]
        for name in ("c_kv", "k_rope"):
            dst[name].narrow(-2, 0, Sq).copy_(src[name])
        return dst
    if "k" not in src:
        return src
    Sq = src["k"].shape[-3]
    for name in ("k", "v"):
        kv = src[name]
        if cfg.kv_cache_dtype == "int8":
            kv, sc = ops.quantize_kv(kv)
            dst[name + "_s"].narrow(-2, 0, Sq).copy_(sc)
        dst[name].narrow(-3, 0, Sq).copy_(kv)
    return dst


def prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                    # (B, S) int
    max_len: int,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt, build the decode cache.  Returns (last_logits, cache)."""
    B, Sq = tokens.shape
    logits, run_cache = forward(params, cfg, tokens, collect_cache=True)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    cache["lengths"].fill_(Sq)
    for key, c in run_cache.items():
        if key == "blocks":
            for j, blk in c.items():
                cache["blocks"][j] = _place(cfg, cache["blocks"][j], blk)
        else:
            cache[key] = _place(cfg, cache[key], c)
    return logits[:, -1], cache


def decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: Dict[str, Any],
    tokens: torch.Tensor,                    # (B,) or (B, 1) int
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for the whole batch; returns (logits (B, V), cache).

    The K/V caches, MLA latents and Mamba states are written in place;
    the returned dict is ``cache`` with ``lengths`` replaced by
    ``lengths + 1``.
    """
    _check_layers(cfg)
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    lengths = cache["lengths"]
    x = L.embed(params, tokens).to(cfg.tdtype)
    for _, kind, p, c in _layers(params, cfg, cache):
        x, _ = _apply_layer_decode(p, cfg, kind, x, c, lengths)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params, x, cfg.tie_embeddings)
    cache["lengths"] = lengths + 1
    return logits[:, 0], cache
