"""Decoder layout, weights and slot-cache forward passes of all 10 configs.

From ``repro/models/transformer.py``: the layer-kind and superblock
layout (``layer_kind``, ``superblock_len``, ``_scan_layout``),
``init_params``, the layer in its full-sequence and decode forms
(``_apply_layer_full``, ``_apply_layer_decode``, ``_apply_ffn``, and
Whisper's ``_audio_dec_layer_full`` / ``_audio_dec_layer_decode``), the
encoder (``encode``, ``_cross_kvs``), ``forward``, and the cache functions
``init_cache``, ``prefill`` and ``decode_step``, and the training loss
``lm_loss``.  A layer's mixer is GQA
attention, cross-attention over encoder K/V, DeepSeek's multi-head latent
attention (MLA), Mamba or an xLSTM cell (mLSTM, sLSTM; :mod:`.ssm`), its
FFN a gated MLP (a leading ``dense_mlp`` layer of an MoE model included),
a mixture of experts with optional shared experts (:mod:`.moe`) or none
(xLSTM).  A Whisper decoder layer is self-attention, cross-attention
under ``norm_x`` and the MLP.

Parameters and caches form the same trees as the JAX package's:
``embedding``, ``lm_head``, ``final_norm``, unstacked prefix layers
``prefix_{i}`` (every layer, when the pattern does not tile the depth),
``blocks[str(j)]`` with every leaf stacked over superblocks on axis 0,
and Whisper's encoder ``encoder`` (stacked over its layers) and
``enc_norm["g"]``.  An attention layer's slot cache is ``{"k", "v"}``
``(B, max_len, K, hd)`` (int8 K/V beside float32 scales ``k_s``/``v_s``
with ``kv_cache_dtype="int8"``), an MLA layer's the compressed latent
``{"c_kv": (B, max_len, kv_lora_rank), "k_rope": (B, max_len,
rope_head_dim)}`` in the compute dtype (whatever ``kv_cache_dtype``), a
Mamba layer's ``{"conv", "ssm"}``, an xLSTM layer's float32 recurrent
state (mLSTM ``{"C", "n", "m"}``, sLSTM ``{"c", "n", "h", "m"}``) and a
cross layer's ``{}``; in ``blocks`` each gains a leading superblock axis.
The VLM's and Whisper's caches add ``"__cross"``: for each cross position
``j`` the encoder K/V ``(n_sb, B, S_enc, K, hd)``, computed once.

In PyTorch's idiom, the ``lax.scan`` over superblocks is a Python loop
over per-layer views, and ``decode_step`` writes the new K/V, latents
and recurrent states into the cache **in place** (it still returns the
cache, with ``lengths`` a new tensor).  MLA decodes in the latent space
(``_mla_decode_absorbed``, plain PyTorch as in the JAX package).

Under an active mesh (:mod:`repro_torch.distributed.sharding`) the
weights are DTensors (``device_put_tree`` onto ``tree_shardings`` of
:func:`param_specs`), the slot caches are made as DTensors laid out by
``zoo.cache_logical``, the residual stream is constrained at JAX's five
places (after the embedding, after each layer, on the logits), and the
returned logits are DTensors.  Without a mesh nothing of this runs.

Two deliberate departures from the JAX functions: ``prefill`` builds the
cross K/V from the encoder output its own ``forward`` computed (JAX's
``init_cache(params=, enc_input=)`` runs the encoder a second time, to
the same values), and an ``audio`` config with an int8 KV cache raises
``NotImplementedError`` (JAX decodes its int8 cache through the float
decode, with undefined results).  ``enc_input`` is cast to the model
dtype for both families (JAX casts the VLM's patches only).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..distributed import sharding as shd
from ..kernels import ops
from . import layers as L
from . import moe as M
from . import ssm as S
from .config import ModelConfig

Params = Dict[str, Any]
KV = Tuple[torch.Tensor, torch.Tensor]
#: the families whose decoder attends to an encoder's output
ENC_FAMILIES = ("vlm", "audio")


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
    p: Params = {"norm1": L.init_rmsnorm(init, cfg.d_model, lead)}
    if mixer in ("attn", "cross"):
        p["attn"] = L.init_attention(init, cfg, lead, cross=mixer == "cross")
    elif mixer == "mla":
        p["attn"] = L.init_mla(init, cfg, lead)
    elif mixer == "mamba":
        p["mamba"] = S.init_mamba(init, cfg, lead)
    elif mixer == "mlstm":
        p["cell"] = S.init_mlstm(init, cfg, lead)
    else:
        p["cell"] = S.init_slstm(init, cfg, lead)
    if ffn != "none":
        p["norm2"] = L.init_rmsnorm(init, cfg.d_model, lead)
    if ffn == "mlp":
        p["mlp"] = L.init_mlp(init, cfg.d_model, cfg.d_ff, lead)
    elif ffn == "dense_mlp":
        p["mlp"] = L.init_mlp(init, cfg.d_model, cfg.moe.d_ff_dense or cfg.d_ff, lead)
    elif ffn == "moe":
        p["moe"] = M.init_moe(init, cfg, lead)
    return p


def _init_decoder_layer_for_audio(init: L.Init, cfg: ModelConfig,
                                  lead: Tuple[int, ...]) -> Params:
    """Whisper decoder layer: self-attn + cross-attn + mlp."""
    d = cfg.d_model
    return {"norm1": L.init_rmsnorm(init, d, lead),
            "attn": L.init_attention(init, cfg, lead),
            "norm_x": L.init_rmsnorm(init, d, lead),
            "xattn": L.init_attention(init, cfg, lead, cross=True),
            "norm2": L.init_rmsnorm(init, d, lead),
            "mlp": L.init_mlp(init, d, cfg.d_ff, lead)}


def init_params(cfg: ModelConfig, seed: int, device: DeviceLike = None) -> Params:
    """Random weights of any of the 10 configs, drawn on ``device``.

    Parameters
    ----------
    cfg : ModelConfig
        The model.
    seed : int
        Seed of the ``torch.Generator`` the weights are drawn from.
    device : str or torch.device, optional
        Where to draw and keep the weights; ``None`` means the CUDA
        device (and raises without one).

    Returns
    -------
    dict
        The parameter tree (the JAX package also returns the logical-axis
        tree; the port's is :func:`param_specs`).
    """
    return _init_tree(cfg, L.Init(seed, cfg.tdtype, resolve_device(device)))


def param_specs(cfg: ModelConfig) -> Params:
    """The logical-axis tree of :func:`init_params`' tree: each leaf a
    tuple of logical names (``None`` for a stacking axis), equal to the
    spec tree JAX's ``init_params`` returns.  Nothing is allocated."""
    return _init_tree(cfg, L.SpecInit())


def _init_tree(cfg: ModelConfig, init: L.Init) -> Params:
    n_prefix, pat, n_sb = _scan_layout(cfg)
    params: Params = L.init_embed(init, cfg)
    params["final_norm"] = L.init_rmsnorm(init, cfg.d_model)
    for i in range(n_prefix):
        params[f"prefix_{i}"] = _init_layer(init, cfg, layer_kind(cfg, i), ())
    if n_sb > 0:
        params["blocks"] = {
            str(j): (_init_decoder_layer_for_audio(init, cfg, (n_sb,))
                     if cfg.family == "audio"
                     else _init_layer(init, cfg, layer_kind(cfg, n_prefix + j), (n_sb,)))
            for j in range(pat)
        }
    if cfg.family == "audio":
        # the conv frontend is a stub: the encoder's inputs are frames
        params["encoder"] = _init_layer(init, cfg, "attn+mlp", (cfg.encoder.n_layers,))
        params["enc_norm"] = {"g": L.init_rmsnorm(init, cfg.d_model)}
    return params


# ---------------------------------------------------------------------------
# forward building blocks
# ---------------------------------------------------------------------------
def _apply_ffn(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
               decoding: bool = False) -> torch.Tensor:
    """Pre-norm FFN with residual: a gated MLP (``mlp``, ``dense_mlp``;
    when ``decoding`` with ``decode_mlp == "ws"``, the weight-stationary
    :func:`~repro_torch.models.layers.mlp_ws_decode`) or the MoE block."""
    _, ffn = kind.split("+")
    if ffn == "none":
        return x
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if ffn == "moe":
        return x + M.moe_block(p["moe"], cfg, h)
    if decoding and cfg.decode_mlp == "ws":
        return x + L.mlp_ws_decode(p["mlp"], cfg, h)
    return x + L.mlp(p["mlp"], h)


def _layer_views(tree: Dict[str, Any], s: int) -> Dict[str, Any]:
    """Superblock ``s`` of a tree stacked on axis 0 (views, no copies)."""
    return {
        k: _layer_views(v, s) if isinstance(v, dict) else v[s]
        for k, v in tree.items()
    }


def _layers(params: Params, cfg: ModelConfig, cache: Optional[Dict[str, Any]] = None,
            cross: Optional[Dict[str, KV]] = None):
    """Every layer in order: ``(name, kind, weights, cache, enc_kv)``.

    ``name`` is ``prefix_{i}`` or ``blocks/{j}``; the weights and cache
    are the layer's own (views into the stacked trees), ``enc_kv`` its
    superblock's view of ``cross[j]`` (or ``None``).  A Whisper decoder
    layer's kind is ``audio_dec``.
    """
    n_prefix, pat, n_sb = _scan_layout(cfg)
    for i in range(n_prefix):
        key = f"prefix_{i}"
        yield key, layer_kind(cfg, i), params[key], None if cache is None else cache[key], None
    kinds = (["audio_dec"] * pat if cfg.family == "audio"
             else [layer_kind(cfg, n_prefix + j) for j in range(pat)])
    cross = cross or {}
    for s in range(n_sb):
        for j in range(pat):
            c = None if cache is None else _layer_views(cache["blocks"][str(j)], s)
            kv = cross.get(str(j))
            yield (f"blocks/{j}", kinds[j], _layer_views(params["blocks"][str(j)], s), c,
                   None if kv is None else (kv[0][s], kv[1][s]))


def _apply_layer_full(
    p: Params,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    enc_kv: Optional[KV] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence layer; returns (x, cache contribution): ``{"k", "v"}``
    of an attention layer (a Whisper decoder layer's self-attention),
    ``{"c_kv", "k_rope"}`` of an MLA one, the final recurrent state of a
    Mamba or xLSTM one, ``None`` of a cross layer."""
    if kind == "audio_dec":
        return _audio_dec_layer_full(p, cfg, x, positions, enc_kv)
    mixer, _ = kind.split("+")
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    cache = None
    if mixer == "attn":
        out, cache = L.attention_full(p["attn"], cfg, h, positions, causal=causal)
    elif mixer == "cross":
        out = L.cross_attention(p["attn"], cfg, h, enc_kv)
    elif mixer == "mla":
        out, cache = L.mla_full(p["attn"], cfg, h, positions)
    elif mixer == "mamba":
        out, cache = S.mamba_full(p["mamba"], cfg, h)
    elif mixer == "mlstm":
        out, cache = S.mlstm_full(p["cell"], cfg, h)
    else:
        out, cache = S.slstm_full(p["cell"], cfg, h)
    x = _apply_ffn(p, cfg, kind, x + out)
    x = shd.constrain(x, ("batch", "seq_act", None))
    return x, cache


def _apply_layer_decode(
    p: Params,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    lengths: torch.Tensor,
    enc_kv: Optional[KV] = None,
) -> torch.Tensor:
    """One-token layer over its slot cache, which is written in place."""
    if kind == "audio_dec":
        return _audio_dec_layer_decode(p, cfg, x, cache, lengths, enc_kv)
    mixer, _ = kind.split("+")
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer in ("mamba", "mlstm", "slstm"):
        if mixer == "mamba":
            out, st = S.mamba_decode(p["mamba"], cfg, h, cache)
        else:
            cell = S.mlstm_full if mixer == "mlstm" else S.slstm_full
            out, st = cell(p["cell"], cfg, h, state=cache)
        for name, t in st.items():
            cache[name].copy_(t)
    elif mixer == "cross":
        out = L.cross_attention(p["attn"], cfg, h, enc_kv)
    elif mixer == "mla":
        out = _mla_decode_absorbed(p["attn"], cfg, h, cache, lengths)
    elif cfg.kv_cache_dtype == "int8":
        out, _ = L.attention_decode_q8(p["attn"], cfg, h, cache, lengths)
    else:
        out, _, _ = L.attention_decode(p["attn"], cfg, h, cache["k"], cache["v"], lengths)
    x = _apply_ffn(p, cfg, kind, x + out, decoding=True)
    return shd.constrain(x, ("dec_batch", None, None))


def _audio_dec_layer_full(p: Params, cfg: ModelConfig, x: torch.Tensor,
                          positions: torch.Tensor,
                          enc_kv: KV) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    out, kv = L.attention_full(p["attn"], cfg, h, positions, causal=True)
    x = x + out
    hx = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
    x = x + L.cross_attention(p["xattn"], cfg, hx, enc_kv)
    h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h2), kv


def _audio_dec_layer_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                            cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                            enc_kv: KV) -> torch.Tensor:
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    out, _, _ = L.attention_decode(p["attn"], cfg, h, cache["k"], cache["v"], lengths)
    x = x + out
    hx = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
    x = x + L.cross_attention(p["xattn"], cfg, hx, enc_kv)
    h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h2)


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
    w_uk = shd.unflatten(p["w_uk"], -1, (h, m.nope_head_dim))
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
    w_uv = shd.unflatten(p["w_uv"], -1, (h, m.v_head_dim))
    out = torch.einsum("bhl,lhv->bhv", ctx, w_uv.float())               # (B, H, v)
    return out.reshape(B, 1, h * m.v_head_dim).to(x.dtype) @ p["wo"]


# ---------------------------------------------------------------------------
# encoder (Whisper) / cross K/V precompute (VLM and Whisper)
# ---------------------------------------------------------------------------
def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over precomputed (stub) frame embeddings ``(B, S_enc,
    d)``: bidirectional ``attn+mlp`` layers with RoPE positions, then
    ``enc_norm``."""
    B, Se, _ = frames.shape
    pos = torch.arange(Se, device=frames.device)[None].expand(B, Se)
    x = frames.to(cfg.tdtype)
    for s in range(cfg.encoder.n_layers):
        x, _ = _apply_layer_full(_layer_views(params["encoder"], s), cfg, "attn+mlp", x,
                                 pos, causal=False)
    return L.rmsnorm(params["enc_norm"]["g"], x, cfg.norm_eps)


def _cross_kvs(params: Params, cfg: ModelConfig, enc_out: torch.Tensor) -> Dict[str, KV]:
    """Every cross layer's K/V, by pattern position ``j``: ``(k, v)``
    each ``(n_sb, B, S_enc, K, hd)``, stacked over superblocks."""
    n_prefix, pat, n_sb = _scan_layout(cfg)
    out: Dict[str, KV] = {}
    for j in range(pat):
        if cfg.family == "audio":
            name = "xattn"
        elif layer_kind(cfg, n_prefix + j).startswith("cross"):
            name = "attn"
        else:
            continue
        kvs = [L.cross_kv(_layer_views(params["blocks"][str(j)][name], s), cfg, enc_out)
               for s in range(n_sb)]
        out[str(j)] = (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))
    return out


def _enc_out(params: Params, cfg: ModelConfig,
             enc_input: Optional[torch.Tensor]) -> torch.Tensor:
    """What the cross layers attend to: Whisper's encoder output, or the
    VLM's patch embeddings in the model dtype."""
    if enc_input is None:
        raise ValueError(f"config {cfg.name!r} (family {cfg.family!r}) needs enc_input: "
                         "its cross layers attend to an encoder's output")
    if cfg.family == "audio":
        return encode(params, cfg, enc_input)
    return enc_input.to(cfg.tdtype)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------
def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                    # (B, S) int
    enc_input: Optional[torch.Tensor] = None,  # VLM patches / Whisper frames
    collect_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (logits (B, S, V), cache or None).

    With ``collect_cache`` the cache holds each layer's contribution:
    ``prefix_{i}`` as it is, and ``blocks[j]`` stacked over superblocks
    as the JAX scan stacks them (K/V ``(n_sb, B, S, K, hd)``, recurrent
    states ``(n_sb, B, ...)``; nothing for a cross layer), and Whisper's
    encoder output under ``"__enc_out"``.  The VLM and Whisper need
    ``enc_input`` (``(B, S_enc, d)``) and raise ``ValueError`` without
    it, where the JAX function cannot run.
    """
    B, Sq = tokens.shape
    x = L.embed(params, tokens).to(cfg.tdtype)
    x = shd.constrain(x, ("batch", None, None))
    positions = torch.arange(Sq, device=tokens.device)[None].expand(B, Sq)
    enc_out, cross = None, {}
    if cfg.family in ENC_FAMILIES:
        enc_out = _enc_out(params, cfg, enc_input)
        cross = _cross_kvs(params, cfg, enc_out)
    caches: Dict[str, Any] = {}
    stacked: Dict[str, list] = {}
    for name, kind, p, _, kv in _layers(params, cfg, cross=cross):
        x, c = _apply_layer_full(p, cfg, kind, x, positions, enc_kv=kv)
        if not collect_cache or c is None:
            continue
        if name.startswith("prefix_"):
            caches[name] = c
        else:
            stacked.setdefault(name.split("/")[1], []).append(c)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params, x, cfg.tie_embeddings)
    logits = shd.constrain(logits, ("batch", None, "vocab_act"))
    if not collect_cache:
        return logits, None
    if stacked:
        caches["blocks"] = {j: {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
                            for j, cs in stacked.items()}
    if cfg.family == "audio":
        caches["__enc_out"] = enc_out
    return logits, caches


# ---------------------------------------------------------------------------
# slot caches: allocation, prefill, decode
# ---------------------------------------------------------------------------
def _check_cache_dtype(cfg: ModelConfig) -> None:
    if cfg.family == "audio" and cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            f"config {cfg.name!r}: an int8 KV cache for the audio family (JAX decodes "
            "it through the float decode, with undefined results)")


@dataclass(frozen=True)
class _Leaf:
    """A cache leaf yet to be made: its shape, dtype and the constant it
    holds (:func:`_make_cache`)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    value: float = 0.0


def _map_leaves(fn, tree, other=None):
    """``fn(leaf, other_leaf)`` over a tree of dicts and tuples of
    :class:`_Leaf` (``other``: a tree of the same structure, or None)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, None if other is None else other[k])
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v, None if other is None else other[i])
                          for i, v in enumerate(tree))
    return fn(tree, other)


def _make_cache(cfg: ModelConfig, tree: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    """Every :class:`_Leaf` of ``tree`` made on ``dev``.

    Under an active mesh each leaf is made on its shards, laid out by
    :func:`repro_torch.models.zoo.cache_logical` (JAX shards its decode
    cache so in the dry-run's cells): DTensor's ``full`` gives each rank
    a tensor of its own shard's shape (``compute_local_shape_and_global_offset``,
    uneven splits included), so no rank allocates the whole cache and no
    collective places it, as JAX's partitioner gives each device its
    shard of the zeros made inside its jitted ``prefill``."""
    mesh = shd.active_mesh()
    if mesh is None:
        return _map_leaves(lambda leaf, _: torch.full(leaf.shape, leaf.value,
                                                      dtype=leaf.dtype, device=dev), tree)
    from torch.distributed.tensor import full

    from .zoo import cache_logical

    specs = cache_logical(cfg, tree, shd.mesh_shape(mesh).get("model", 1))
    return _map_leaves(
        lambda leaf, sh: full(leaf.shape, leaf.value, dtype=leaf.dtype,
                              device_mesh=sh.mesh, placements=list(sh.placements)),
        tree, shd.tree_shardings(specs, tree, mesh))


def _slot_caches(cfg: ModelConfig, batch: int, max_len: int,
                 dev: torch.device) -> Dict[str, Any]:
    """``lengths`` and every layer's empty cache (see :func:`init_cache`),
    made by :func:`_make_cache`."""
    _check_cache_dtype(cfg)
    n_prefix, pat, n_sb = _scan_layout(cfg)

    def layer_cache(kind: str, lead: Tuple[int, ...]) -> Dict[str, _Leaf]:
        mixer = kind.split("+")[0]
        if mixer == "cross":
            return {}
        if mixer == "mamba":
            return S.mamba_init_state(cfg, batch, cfg.tdtype, dev, lead, full=_Leaf)
        if mixer in ("mlstm", "slstm"):
            return S.xlstm_init_state(cfg, batch, mixer == "slstm", dev, lead, full=_Leaf)
        if mixer == "mla":
            m = cfg.mla
            return {"c_kv": _Leaf(lead + (batch, max_len, m.kv_lora_rank), cfg.tdtype),
                    "k_rope": _Leaf(lead + (batch, max_len, m.rope_head_dim), cfg.tdtype)}
        shape = lead + (batch, max_len, cfg.n_kv_heads, cfg.hd)
        if cfg.kv_cache_dtype == "int8":
            return {"k": _Leaf(shape, torch.int8), "v": _Leaf(shape, torch.int8),
                    "k_s": _Leaf(shape[:-1], torch.float32),
                    "v_s": _Leaf(shape[:-1], torch.float32)}
        return {"k": _Leaf(shape, cfg.tdtype), "v": _Leaf(shape, cfg.tdtype)}

    cache: Dict[str, Any] = {"lengths": _Leaf((batch,), torch.int32)}
    for i in range(n_prefix):
        cache[f"prefix_{i}"] = layer_cache(layer_kind(cfg, i), ())
    if n_sb > 0:
        cache["blocks"] = {
            str(j): layer_cache("attn+mlp" if cfg.family == "audio"
                                else layer_kind(cfg, n_prefix + j), (n_sb,))
            for j in range(pat)}
    return _make_cache(cfg, cache, dev)


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    device: DeviceLike = None,
    enc_input: Optional[torch.Tensor] = None,
    params: Optional[Params] = None,
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
    (:func:`repro_torch.models.ssm.mamba_init_state`), an xLSTM layer's
    the cell's fresh state (:func:`repro_torch.models.ssm.xlstm_init_state`),
    a cross layer's ``{}``.  Leaves under ``blocks`` gain a leading
    superblock axis.  The VLM and Whisper add ``"__cross"``: the cross
    layers' K/V of ``enc_input`` when ``params`` and ``enc_input`` are
    given, else zeros of ``encoder.n_ctx`` tokens (a placeholder that
    ``prefill`` fills in real runs).
    """
    dev = resolve_device(device)
    cache = _slot_caches(cfg, batch, max_len, dev)
    if cfg.family not in ENC_FAMILIES:
        return cache
    if params is not None and enc_input is not None:
        cache["__cross"] = _cross_kvs(params, cfg, _enc_out(params, cfg, enc_input))
        return cache
    n_prefix, pat, n_sb = _scan_layout(cfg)
    Se = cfg.encoder.n_ctx if cfg.encoder is not None else 0
    shape = (n_sb, batch, Se, cfg.n_kv_heads, cfg.hd)
    cross = {str(j): (_Leaf(shape, cfg.tdtype), _Leaf(shape, cfg.tdtype))
             for j in range(pat)
             if Se and (cfg.family == "audio"
                        or layer_kind(cfg, n_prefix + j).startswith("cross"))}
    if cross:
        cache["__cross"] = _make_cache(cfg, {"__cross": cross}, dev)["__cross"]
    return cache


def _place(cfg: ModelConfig, dst: Dict[str, torch.Tensor],
           src: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A prefill contribution in a fresh layer cache: the prompt's K/V in
    its first positions (quantized on an int8 cache, JAX's
    ``place_attn_q8``), an MLA layer's latents in their first positions,
    or a recurrent layer's final state in place of the initial one."""
    if "c_kv" in src:
        for name in ("c_kv", "k_rope"):
            shd.narrow_copy_(dst[name], -2, src[name])
        return dst
    if "k" not in src:
        return src
    for name in ("k", "v"):
        kv = src[name]
        if cfg.kv_cache_dtype == "int8":
            kv, sc = ops.quantize_kv(kv)
            shd.narrow_copy_(dst[name + "_s"], -2, sc)
        shd.narrow_copy_(dst[name], -3, kv)
    return dst


def prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                    # (B, S) int
    max_len: int,
    enc_input: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt, build the decode cache.  Returns (last_logits, cache).

    The VLM's and Whisper's ``"__cross"`` K/V come from the encoder
    output this prefill's ``forward`` computed (JAX's ``init_cache``
    encodes ``enc_input`` again, to the same values).
    """
    B, Sq = tokens.shape
    logits, run_cache = forward(params, cfg, tokens, enc_input=enc_input,
                                collect_cache=True)
    cache = _slot_caches(cfg, B, max_len, tokens.device)
    cache["lengths"].fill_(Sq)
    if cfg.family in ENC_FAMILIES:
        enc_out = run_cache.pop("__enc_out", None)
        cache["__cross"] = _cross_kvs(params, cfg, _enc_out(params, cfg, enc_input)
                                      if enc_out is None else enc_out)
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

    The K/V caches, MLA latents and recurrent states are written in place;
    cross layers read ``cache["__cross"]``; the returned dict is ``cache``
    with ``lengths`` replaced by ``lengths + 1``.
    """
    _check_cache_dtype(cfg)
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    lengths = cache["lengths"]
    x = L.embed(params, tokens).to(cfg.tdtype)
    x = shd.constrain(x, ("dec_batch", None, None))
    for _, kind, p, c, kv in _layers(params, cfg, cache, cache.get("__cross")):
        x = _apply_layer_decode(p, cfg, kind, x, c, lengths, enc_kv=kv)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params, x, cfg.tie_embeddings)
    cache["lengths"] = lengths + 1
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def lm_loss(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                      # (B, S) int
    targets: torch.Tensor,                     # (B, S) int
    enc_input: Optional[torch.Tensor] = None,  # VLM patches / Whisper frames
) -> torch.Tensor:
    """Mean next-token cross-entropy: float32 logits, logsumexp, the gold
    logit gathered, mean over every position (a 0-dim float32 tensor).

    ``forward`` writes nothing in place on this path, so autograd
    differentiates it as it stands; on CUDA tensors its flash attention and
    RMSNorm calls take the kernels' autograd functions
    (``repro_torch.kernels.ops``).  DTensor logits (under a mesh) take
    :func:`_sharded_token_losses`, and the loss is a plain 0-dim tensor
    there too.
    """
    logits, _ = forward(params, cfg, tokens, enc_input=enc_input)
    if shd.is_dtensor(logits):
        return torch.mean(_sharded_token_losses(logits, targets)).full_tensor()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _sharded_token_losses(logits, targets: torch.Tensor):
    """Each position's ``logsumexp - gold`` of DTensor ``logits``, vocab-
    parallel: each rank holds the rows of the ``batch`` rule and the vocab
    columns of ``vocab_act``; the max, the sum of exponentials and the gold
    logit (on the rank that holds its column) are reduced over the vocab's
    mesh dims, so the ``(B, S, V)`` logits are never gathered.  A DTensor
    sharded as the rows."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    mesh = logits.device_mesh
    spec = shd.resolve_spec(("batch", None, "vocab_act"), logits.shape, mesh)
    pls = shd.placements_of(spec, mesh)
    groups = [mesh.get_group(m) for m, pl in enumerate(pls)
              if isinstance(pl, Shard) and pl.dim == 2]
    v0, nv = shd.shard_offsets(logits, pls)[2]

    def body(lg, tg):
        lg = lg.float()
        mx = lg.detach().amax(-1)
        for g in groups:
            dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=g)
        se = torch.exp(lg - mx[..., None]).sum(-1)
        idx = tg.long() - v0
        hit = (idx >= 0) & (idx < nv)
        gold = torch.where(hit, torch.gather(lg, -1, idx.clamp(0, nv - 1)[..., None])[..., 0],
                           torch.zeros((), device=lg.device))
        for g in groups:
            se, gold = shd.psum(se, g), shd.psum(gold, g)
        return mx + torch.log(se) - gold

    rows = shd.placements_of(spec[:2], mesh)
    return shd.local_call(body, [logits, targets], [pls, rows], rows, mesh)
