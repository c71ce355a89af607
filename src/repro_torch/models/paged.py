"""Paged KV-cache model path (vLLM-style) for the serving engine.

Port of ``repro/models/paged.py``.  K/V live in a shared pool of
fixed-size pages, ``(P, page_size, K, hd)`` per layer, stacked over
superblocks as ``(n_sb, P, page_size, K, hd)``, and each request owns a
*block table* mapping logical token positions to physical pages.  The
same block table serves every layer, so allocation is one host-side
decision per page.

Three entry points:

- :func:`init_paged_pools` — allocate the per-layer page pools;
- :func:`paged_prefill_chunk` — run one prompt chunk (attending to the
  pages written by earlier chunks) and scatter its K/V into the pools;
- :func:`paged_decode_step` — one decode token for a batch of requests.

Differences from the JAX original, in PyTorch's idiom:

- the pools are updated **in place** (an ``index_copy_`` into the
  ``(P*ps, K, hd)`` view of each layer's pool), where JAX rebuilt them
  functionally and relied on buffer donation; both step functions still
  return the pools for signature parity, and the returned dict is the
  one passed in;
- the ``lax.scan`` over superblocks is a Python loop over layers, on
  per-layer views ``pool[s]`` and ``param[s]``.

``kv_dtype="fp32"`` pages hold the model's compute dtype;
``kv_dtype="int8"`` pages hold int8 K/V beside float32 per-page scale
pools ``k_s``/``v_s`` ``(n_sb, P, page_size, K)``: each token is
quantized once, on scatter, and the int8 kernels dequantize the pages
they read.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..kernels import ops
from . import layers as L
from .config import ModelConfig
from .transformer import _apply_ffn, _layer_views, _scan_layout, layer_kind

Params = Dict[str, Any]
Pools = Dict[str, Any]

KV_DTYPES = ("fp32", "int8")


def supports_paged(cfg: ModelConfig) -> bool:
    """True when every layer's mixer is plain GQA attention."""
    if cfg.family not in ("dense", "moe") or cfg.kv_cache_dtype == "int8":
        return False
    if cfg.mla is not None or cfg.mamba is not None or cfg.encoder is not None:
        return False
    n_prefix, pat, n_sb = _scan_layout(cfg)
    if n_prefix or n_sb == 0:
        return False
    kinds = [layer_kind(cfg, j).split("+")[0] for j in range(pat)]
    return all(k == "attn" for k in kinds)


def init_paged_pools(
    cfg: ModelConfig,
    num_pages: int,
    page_size: int,
    kv_dtype: str = "fp32",
    device: DeviceLike = None,
) -> Pools:
    """Per-pattern-position page pools, stacked over superblocks.

    ``pools["blocks"][j]`` is ``{"k","v": (n_sb, P, page_size, K, hd)}``
    in the model's compute dtype, zero-filled, on ``device`` (``None``
    means the CUDA device).  With ``kv_dtype="int8"`` the K/V leaves are
    int8 zeros and the scale pools ``{"k_s","v_s": (n_sb, P, page_size,
    K)}`` float32 ones (a neutral scale: never-written slots dequantize
    to finite values the kernels' masking then discards).
    """
    if not supports_paged(cfg):
        raise ValueError(
            f"config {cfg.name!r} is not paged-KV compatible "
            "(requires a pure-attention decoder, fp/bf16 cache)"
        )
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    dev = resolve_device(device)
    _, pat, n_sb = _scan_layout(cfg)
    kv_shape = (n_sb, num_pages, page_size, cfg.n_kv_heads, cfg.hd)

    def one_pool() -> Dict[str, torch.Tensor]:
        if kv_dtype == "int8":
            return {
                "k": torch.zeros(kv_shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(kv_shape, dtype=torch.int8, device=dev),
                "k_s": torch.ones(kv_shape[:-1], dtype=torch.float32, device=dev),
                "v_s": torch.ones(kv_shape[:-1], dtype=torch.float32, device=dev),
            }
        return {"k": torch.zeros(kv_shape, dtype=cfg.tdtype, device=dev),
                "v": torch.zeros(kv_shape, dtype=cfg.tdtype, device=dev)}

    return {"blocks": {str(j): one_pool() for j in range(pat)}}


def _write_kv(pool: Dict[str, torch.Tensor], flat_idx: torch.Tensor,
              k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Scatter one batch of K/V tokens into one layer's pool, in place,
    quantizing when the pool is int8.

    ``pool`` holds ``(P, ps, K, hd)`` views (and ``(P, ps, K)`` scale
    views on int8 pools); ``k``/``v`` are ``(T, K, hd)`` and
    ``flat_idx`` the ``(T,)`` slots ``page*ps + off``.  Returns ``pool``.
    """
    for name, val in (("k", k), ("v", v)):
        arr = pool[name]
        P, ps, K, hd = arr.shape
        if name + "_s" in pool:
            val, sc = ops.quantize_kv(val)
            pool[name + "_s"].view(P * ps, K).index_copy_(0, flat_idx, sc)
        arr.view(P * ps, K, hd).index_copy_(0, flat_idx, val.to(arr.dtype))
    return pool


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def paged_decode_step(
    params: Params,
    cfg: ModelConfig,
    pools: Pools,
    tokens: torch.Tensor,        # (B,) int — one new token per request
    block_tables: torch.Tensor,  # (B, pages_per_seq) int32
    lengths: torch.Tensor,       # (B,) int32 — tokens already in cache
) -> Tuple[torch.Tensor, Pools]:
    """One decode step over paged KV; returns (logits (B, V), pools).

    The pools are written in place (the new token of row b lands at
    position ``lengths[b]``).
    """
    B = tokens.shape[0]
    _, pat, n_sb = _scan_layout(cfg)
    ps = pools["blocks"]["0"]["k"].shape[2]
    x = L.embed(params, tokens[:, None]).to(cfg.tdtype)

    lens = lengths.long()
    rows = torch.arange(B, device=tokens.device)
    write_page = block_tables[rows, lens // ps].long()        # (B,)
    write_flat = write_page * ps + lens % ps                  # (B,)
    attn_lens = (lengths + 1).to(torch.int32)
    kinds = [layer_kind(cfg, j) for j in range(pat)]
    pos = lens[:, None]

    for s in range(n_sb):
        for j in range(pat):
            p = _layer_views(params["blocks"][str(j)], s)
            pool = _layer_views(pools["blocks"][str(j)], s)
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            q, k, v = L._proj_qkv(p["attn"], cfg, h, h)        # (B,1,·,hd)
            q = L.rope(q, pos, cfg.rope_theta)
            k = L.rope(k, pos, cfg.rope_theta)
            _write_kv(pool, write_flat, k[:, 0], v[:, 0])
            out = ops.paged_decode_attention(
                q[:, 0], pool["k"], pool["v"], block_tables, attn_lens,
                k_scales=pool.get("k_s"), v_scales=pool.get("v_s"),
            )
            x = x + out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
            x = _apply_ffn(p, cfg, kinds[j], x)

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params, x, cfg.tie_embeddings)
    return logits[:, 0], pools


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------
def paged_prefill_chunk(
    params: Params,
    cfg: ModelConfig,
    pools: Pools,
    tokens: torch.Tensor,       # (1, C) int — this chunk of the prompt
    block_table: torch.Tensor,  # (pages_per_seq,) int32
    past: int,                  # tokens of this prompt already prefilled
) -> Tuple[torch.Tensor, Pools]:
    """Run one prompt chunk for a single request; returns (logits, pools).

    The chunk's queries attend causally to (already-paged history + the
    chunk itself); its K/V are scattered into the pools at positions
    ``past .. past+C`` before the fused paged-prefill attention reads
    them.  Returned logits cover the whole chunk, ``(1, C, V)``.
    """
    _, pat, n_sb = _scan_layout(cfg)
    ps = pools["blocks"]["0"]["k"].shape[2]
    C = tokens.shape[1]
    x = L.embed(params, tokens).to(cfg.tdtype)
    tok_pos = past + torch.arange(C, device=tokens.device)
    positions = tok_pos[None, :]                              # (1, C)
    write_flat = block_table[tok_pos // ps].long() * ps + tok_pos % ps
    kinds = [layer_kind(cfg, j) for j in range(pat)]

    for s in range(n_sb):
        for j in range(pat):
            p = _layer_views(params["blocks"][str(j)], s)
            pool = _layer_views(pools["blocks"][str(j)], s)
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            q, k, v = L._proj_qkv(p["attn"], cfg, h, h)
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
            _write_kv(pool, write_flat, k[0], v[0])
            out = ops.paged_prefill_attention(
                q[0], pool["k"], pool["v"], block_table, past,
                k_scales=pool.get("k_s"), v_scales=pool.get("v_s"),
            )[None]
            x = x + out.reshape(1, C, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
            x = _apply_ffn(p, cfg, kinds[j], x)

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params, x, cfg.tie_embeddings)
    return logits, pools
