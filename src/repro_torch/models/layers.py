"""Transformer layers: plain functions on tensors.

The subset of ``repro/models/layers.py`` the serving paths run:
``embed``, ``rmsnorm``, ``rope``, ``_proj_qkv``, ``attention_full`` and
``attention_decode`` (the slot engine's prefill and decode),
``attention_decode_q8`` with ``_dq8_kv`` (decode over the int8 slot
cache; JAX's ``_q8_kv`` is the paged pools' spec, so the port quantizes
with :func:`repro_torch.kernels.ops.quantize_kv`), cross-attention over
precomputed encoder K/V (``init_attention(cross=True)``, ``cross_kv``,
``cross_attention``: the VLM's and Whisper's decoders), DeepSeek's
multi-head latent attention (``init_mla``, ``_mla_qkv``, ``_mla_expand``,
``mla_full`` with its compressed ``{"c_kv", "k_rope"}`` cache, and
``mla_decode``), ``mlp``, the weight-stationary decode MLP
``mlp_ws_decode`` and ``unembed``, with the ``init_*`` functions of
their weights.  Each ``init_*`` names the logical axes of its leaves as
JAX's ``Maker.dense`` does (:class:`SpecInit` builds that tree).

Under a mesh (:mod:`repro_torch.distributed.sharding`) the same
functions take DTensor weights and activations: the products, RoPE and
the elementwise math run on DTensors, the kernels on local shards
(:mod:`repro_torch.kernels.ops`), ``embed`` gathers from a vocab-sharded
table on its local rows, a head split gathers a projection whose shards
would cut a head, and the in-place cache writes go to the local shards.
Parameters are plain nested dicts of tensors with the
JAX package's names, shapes and dtypes; the matrix products stay
``x @ w`` (outside any kernel, as the JAX package left them to XLA),
and RMSNorm and attention go through :mod:`repro_torch.kernels.ops`
(the CUDA kernels for CUDA tensors).

Weights are drawn as in the JAX package — normal with
``std = 1/sqrt(fan_in)``, drawn in float32 and cast to the model dtype —
but from a seeded ``torch.Generator`` on the target device, so a
full-width model is initialised on the card.  The values differ from
JAX's for the same seed; the tests bridge JAX's weights instead.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..distributed import sharding as shd
from ..kernels import ops
from .config import ModelConfig

Params = Dict[str, Any]
Shape = Tuple[int, ...]
#: logical axis names of a leaf's dims (``None``: not named)
Spec = Tuple[Optional[str], ...]
#: most elements :meth:`Init.dense` draws at once (1 GiB of float32)
WHOLE_DRAW = 1 << 28


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
class Init:
    """Seeded weight factory on one device.

    Parameters
    ----------
    seed : int
        Seed of the ``torch.Generator`` every draw comes from, in order.
    dtype : torch.dtype
        Dtype of the returned weights.
    device : torch.device or str
        Device the weights are drawn and kept on.  ``"meta"`` builds
        shapes and dtypes only (no generator, nothing allocated).
    """

    def __init__(self, seed: int, dtype: torch.dtype, device) -> None:
        self.dtype = dtype
        self.device = torch.device(device)
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(seed)

    def dense(self, shape: Shape, fan_in: int, spec: Spec = ()) -> torch.Tensor:
        """Normal with ``std = 1/sqrt(fan_in)``, drawn in float32 and cast.

        ``spec`` names the logical axes of the unstacked shape (JAX's
        ``Maker.dense`` spec); :class:`SpecInit` returns it in place of
        the tensor.

        A tensor of more than :data:`WHOLE_DRAW` elements is drawn in
        slabs along its first axis, so the float32 temporary stays near
        1 GiB (a full-width MoE expert stack would need 12.9 GB); where one
        index of the first axis holds more than that (a stack of such
        expert tensors over superblocks), each index is drawn in slabs of
        its own, in order.
        """
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        if self.gen is not None:      # a meta tensor has nothing to draw
            self._fill(out, 1.0 / math.sqrt(max(1, fan_in)))
        return out

    def _fill(self, out: torch.Tensor, std: float) -> None:
        inner = tuple(out.shape[1:])
        if inner and math.prod(inner) > WHOLE_DRAW:
            for sub in out:
                self._fill(sub, std)
            return
        rows = max(1, WHOLE_DRAW // math.prod(inner))
        for i in range(0, out.shape[0], rows):
            n = min(rows, out.shape[0] - i)
            w = torch.randn((n,) + inner, generator=self.gen, device=self.device,
                            dtype=torch.float32)
            out[i:i + n] = w * std

    def ones(self, shape: Shape, spec: Spec) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, shape: Shape, spec: Spec) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def const(self, value: torch.Tensor, spec: Spec) -> torch.Tensor:
        """A leaf computed by the caller (Mamba's ``A_log``), kept as it is."""
        return value


def _stacked(spec: Spec, shape: Shape) -> Spec:
    """``spec`` of the unstacked shape behind ``None`` for each stacking
    axis (JAX's ``(None,) + spec`` of a stacked leaf)."""
    return (None,) * (len(shape) - len(spec)) + tuple(spec)


class SpecInit(Init):
    """The factory of the logical-axis tree: each leaf is its spec tuple
    (JAX's ``Maker.specs``), nothing is drawn or allocated."""

    def __init__(self) -> None:
        super().__init__(0, torch.float32, "meta")

    def dense(self, shape: Shape, fan_in: int, spec: Spec = ()) -> Spec:
        return _stacked(spec, shape)

    def ones(self, shape: Shape, spec: Spec) -> Spec:
        return _stacked(spec, shape)

    def zeros(self, shape: Shape, spec: Spec) -> Spec:
        return _stacked(spec, shape)

    def const(self, value: torch.Tensor, spec: Spec) -> Spec:
        return _stacked(spec, tuple(value.shape))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def init_rmsnorm(init: Init, d: int, lead: Shape = ()) -> torch.Tensor:
    return init.ones(lead + (d,), (None,))


def rmsnorm(gamma: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return ops.rmsnorm(x, gamma, eps=eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  f32 math, cast back."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(theta, exps)
    ang = positions[..., None].float() * freqs                  # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention projections
# ---------------------------------------------------------------------------
def init_attention(init: Init, cfg: ModelConfig, lead: Shape = (),
                   cross: bool = False) -> Params:
    """GQA projections; a ``cross`` layer (keys and values from the
    encoder) has no QKV bias, whatever ``qkv_bias``."""
    d, hd = cfg.d_model, cfg.hd
    h, k = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": init.dense(lead + (d, h * hd), fan_in=d, spec=("embed", "heads")),
        "wk": init.dense(lead + (d, k * hd), fan_in=d, spec=("embed", "kv_heads")),
        "wv": init.dense(lead + (d, k * hd), fan_in=d, spec=("embed", "kv_heads")),
        "wo": init.dense(lead + (h * hd, d), fan_in=h * hd, spec=("heads", "embed")),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = init.zeros(lead + (h * hd,), ("heads",))
        p["bk"] = init.zeros(lead + (k * hd,), ("kv_heads",))
        p["bv"] = init.zeros(lead + (k * hd,), ("kv_heads",))
    return p


def _proj_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor, kv_src: torch.Tensor):
    B, S, _ = x.shape
    Skv = kv_src.shape[1]
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = shd.unflatten(x @ p["wq"], -1, (h, hd))
    kk = shd.unflatten(kv_src @ p["wk"], -1, (k, hd))
    v = shd.unflatten(kv_src @ p["wv"], -1, (k, hd))
    if "bq" in p:
        q = q + shd.unflatten(p["bq"], -1, (h, hd))
        kk = kk + shd.unflatten(p["bk"], -1, (k, hd))
        v = v + shd.unflatten(p["bv"], -1, (k, hd))
    return q, kk, v


def attention_full(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,               # (B, S, d)
    positions: torch.Tensor,       # (B, S)
    causal: bool = True,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (prefill).  Returns (out, {"k", "v"})."""
    q, k, v = _proj_qkv(p, cfg, x, x)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = ops.attention(q, k, v, causal=causal)
    out = shd.merge_heads(out) @ p["wo"]
    return out, {"k": k, "v": v}


def write_at_lengths(cache: torch.Tensor, new: torch.Tensor,
                     lengths: torch.Tensor) -> None:
    """Write row b of ``new`` (B, ...) into ``cache`` (B, S_max, ...) at
    position ``lengths[b]``, **in place**; a row whose length has reached
    ``S_max`` writes nothing (JAX's one-hot of an out-of-range index is
    all zeros).

    A DTensor cache is written on its local shards: ``new`` and
    ``lengths`` are laid out as the cache's batch and head dims, and a
    shard of the sequence dim (``kv_seq``) writes the rows whose position
    falls in it.
    """
    if shd.is_dtensor(cache):
        _write_sharded(cache, new, lengths)
        return
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    at = lengths.long().clamp(max=S - 1)
    keep = (lengths >= S).view((B,) + (1,) * (new.dim() - 1))
    cache[rows, at] = torch.where(keep, cache[rows, at], new.to(cache.dtype))


def _write_sharded(cache, new: torch.Tensor, lengths: torch.Tensor) -> None:
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    # new has the cache's dims without the sequence dim (1)
    new_pls = [Shard(pl.dim - (pl.dim > 1)) if isinstance(pl, Shard) and pl.dim != 1
               else Replicate() for pl in cache.placements]
    len_pls = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
               for pl in cache.placements]
    new_l = shd.local_shard(new, mesh, new_pls)
    s0, ns = shd.shard_offsets(cache)[1]
    at = shd.local_shard(lengths, mesh, len_pls) - s0
    # a position before this shard writes nothing here, as one past it
    write_at_lengths(cache.to_local(), new_l, torch.where(at < 0, ns, at))


def attention_decode(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,               # (B, 1, d)
    cache_k: torch.Tensor,         # (B, S_max, K, hd)
    cache_v: torch.Tensor,
    lengths: torch.Tensor,         # (B,) int32 tokens already in cache
    use_rope: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode; returns (out, cache_k, cache_v).

    The new K/V of row b are written **in place** at position
    ``lengths[b]`` (the JAX version adds a one-hot row to a cache whose
    slot there is zero, which stores the same values).  A row whose
    length has reached ``S_max`` writes nothing, as the JAX one-hot of
    an out-of-range index is all zeros.
    """
    B = x.shape[0]
    q, k, v = _proj_qkv(p, cfg, x, x)
    if use_rope:
        pos = lengths[:, None]
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    write_at_lengths(cache_k, k[:, 0], lengths)
    write_at_lengths(cache_v, v[:, 0], lengths)
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, (lengths + 1).to(torch.int32))
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"]
    return out, cache_k, cache_v


def _dq8_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def attention_decode_q8(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                    # (B, 1, d)
    cache: Dict[str, torch.Tensor],     # {k,v: int8 (B,S,K,hd); k_s,v_s: (B,S,K)}
    lengths: torch.Tensor,              # (B,) int32 tokens already in cache
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode over an int8-quantized slot cache; returns (out, cache).

    The new K/V are quantized at write and stored **in place** with their
    scales at position ``lengths[b]`` (nothing for a row at ``S_max``, as
    JAX's out-of-range one-hot).  The whole cache is then dequantized to
    the compute dtype and goes through the slot decode-attention kernel.
    """
    B = x.shape[0]
    q, k, v = _proj_qkv(p, cfg, x, x)
    if use_rope:
        pos = lengths[:, None]
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    kq, ks = ops.quantize_kv(k[:, 0])     # (B, K, hd), (B, K)
    vq, vs = ops.quantize_kv(v[:, 0])
    for name, new in (("k", kq), ("v", vq), ("k_s", ks), ("v_s", vs)):
        write_at_lengths(cache[name], new, lengths)
    k_deq = _dq8_kv(cache["k"], cache["k_s"], cfg.tdtype)
    v_deq = _dq8_kv(cache["v"], cache["v_s"], cfg.tdtype)
    out = ops.decode_attention(q[:, 0], k_deq, v_deq, (lengths + 1).to(torch.int32))
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"]
    return out, cache


def cross_attention(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                                 # (B, S, d)
    enc_kv: Tuple[torch.Tensor, torch.Tensor],       # (k, v): (B, S_enc, K, hd)
) -> torch.Tensor:
    """Decoder queries over precomputed encoder K/V: bidirectional, no
    RoPE, through the flash kernel with Sq != Sk (Sq = 1 in decode)."""
    h, hd = cfg.n_heads, cfg.hd
    q = shd.unflatten(x @ p["wq"], -1, (h, hd))
    k, v = enc_kv
    out = ops.attention(q, k, v, causal=False)
    return shd.merge_heads(out) @ p["wo"]


def cross_kv(p: Params, cfg: ModelConfig,
             enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A cross layer's K/V ``(B, S_enc, K, hd)`` of the encoder output."""
    B, Se, _ = enc_out.shape
    k = shd.unflatten(enc_out @ p["wk"], -1, (cfg.n_kv_heads, cfg.hd))
    v = shd.unflatten(enc_out @ p["wv"], -1, (cfg.n_kv_heads, cfg.hd))
    return k, v


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------
def init_mla(init: Init, cfg: ModelConfig, lead: Shape = ()) -> Params:
    """MLA projections: ``wq``, the KV down-projection ``w_dkv`` to the
    latent plus the shared rope key, its up-projections ``w_uk``/``w_uv``,
    and ``wo`` (fan-in: the first axis of each unstacked shape)."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    lora = m.kv_lora_rank
    return {
        "wq": init.dense(lead + (d, h * qd), fan_in=d, spec=("embed", "heads")),
        "w_dkv": init.dense(lead + (d, lora + m.rope_head_dim), fan_in=d,
                            spec=("embed", "lora")),
        "w_uk": init.dense(lead + (lora, h * m.nope_head_dim), fan_in=lora,
                           spec=("lora", "heads")),
        "w_uv": init.dense(lead + (lora, h * m.v_head_dim), fan_in=lora,
                           spec=("lora", "heads")),
        "wo": init.dense(lead + (h * m.v_head_dim, d), fan_in=h * m.v_head_dim,
                         spec=("heads", "embed")),
    }


def _mla_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Project to MLA q and the compressed kv; returns (q_nope, q_rope,
    c_kv, k_rope), the rope keys through a head axis of 1."""
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    q = shd.unflatten(x @ p["wq"], -1, (h, qd))
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    dkv = x @ p["w_dkv"]
    c_kv, k_rope = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand(p: Params, cfg: ModelConfig, c_kv: torch.Tensor,
                k_rope: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand the compressed cache into per-head K/V (B, S, H, ·)."""
    m = cfg.mla
    B, S, _ = c_kv.shape
    h = cfg.n_heads
    k_nope = shd.unflatten(c_kv @ p["w_uk"], -1, (h, m.nope_head_dim))
    v = shd.unflatten(c_kv @ p["w_uv"], -1, (h, m.v_head_dim))
    k_rope_b = k_rope[:, :, None, :].expand(B, S, h, m.rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def mla_full(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,               # (B, S, d)
    positions: torch.Tensor,       # (B, S)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence MLA (prefill) through the flash kernel at head dims
    nope + rope / v (DeepSeek: 192 / 128).  Returns (out, the compressed
    cache ``{"c_kv", "k_rope"}``)."""
    m = cfg.mla
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    k, v = _mla_expand(p, cfg, c_kv, k_rope)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    out = ops.attention(q, k, v, causal=True, scale=scale)
    out = shd.merge_heads(out) @ p["wo"]
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,               # (B, 1, d)
    cache_c: torch.Tensor,         # (B, S_max, kv_lora_rank)
    cache_r: torch.Tensor,         # (B, S_max, rope_head_dim)
    lengths: torch.Tensor,         # (B,) int32 tokens already in cache
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token MLA decode over the expanded cache through the slot
    decode kernel at head dims nope + rope / v; returns (out, cache_c,
    cache_r), the new latent written in place at ``lengths[b]``.  (The
    engine decodes MLA with the absorbed form in ``transformer.py``.)"""
    m = cfg.mla
    B = x.shape[0]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, lengths[:, None])
    write_at_lengths(cache_c, c_kv[:, 0], lengths)
    write_at_lengths(cache_r, k_rope[:, 0], lengths)
    k, v = _mla_expand(p, cfg, cache_c, cache_r)
    q = torch.cat([q_nope, q_rope], dim=-1)[:, 0]
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    out = ops.decode_attention(q, k, v, (lengths + 1).to(torch.int32), scale=scale)
    out = out.reshape(B, 1, cfg.n_heads * m.v_head_dim) @ p["wo"]
    return out, cache_c, cache_r


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------
def init_mlp(init: Init, d: int, ff: int, lead: Shape = ()) -> Params:
    return {
        "w_gate": init.dense(lead + (d, ff), fan_in=d, spec=("embed", "ff")),
        "w_up": init.dense(lead + (d, ff), fan_in=d, spec=("embed", "ff")),
        "w_down": init.dense(lead + (ff, d), fan_in=ff, spec=("ff", "embed")),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


#: calls of the weight-stationary body and of its fallback to ``mlp`` since
#: the last reset (the tests and the card show which one a decode took)
WS_CALLS = {"ws_body": 0, "fallback": 0}


def reset_ws_calls() -> None:
    for k in WS_CALLS:
        WS_CALLS[k] = 0


def mlp_ws_decode(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Weight-stationary decode MLP (serve_opt2 variant).

    At decode the activations are tiny (B tokens) while the fsdp-sharded
    weights are huge; this keeps every weight shard where it lives and
    moves only activation partials, on the local shards:

        x (replicated) --slice d over data--> partial h  --all-reduce(data)-->
        silu·u in float32 --local (ff/model)--> partial y --all-reduce(model)-->
        y, sharded on d over data

    Without an active mesh with ``data`` and ``model`` dims that divide
    ``d`` and the FFN width it is :func:`mlp`, where JAX's is.
    """
    mesh = shd.active_mesh()
    d = cfg.d_model
    ff = p["w_gate"].shape[-1]
    shape = shd.mesh_shape(mesh) if mesh is not None else {}
    if (
        mesh is None
        or "data" not in shape
        or "model" not in shape
        or d % (shape["data"]) or ff % shape["model"]
        or d % shape["data"]
    ):
        WS_CALLS["fallback"] += 1
        return mlp(p, x)
    WS_CALLS["ws_body"] += 1
    d_l = d // shape["data"]
    g_data, g_model = mesh.get_group("data"), mesh.get_group("model")

    def body(xl, wg, wu, wd):
        i = mesh.get_local_rank("data")
        xs = xl.narrow(-1, i * d_l, d_l)
        h = xs @ wg
        dist.all_reduce(h, group=g_data)          # (B, 1, ff/model)
        u = xs @ wu
        dist.all_reduce(u, group=g_data)
        a = (F.silu(h.float()) * u.float()).to(xl.dtype)
        y = a @ wd
        dist.all_reduce(y, group=g_model)         # (B, 1, d/data)
        return y

    def pl(*spec):
        return shd.placements_of(spec, mesh)

    return shd.local_call(
        body, [x, p["w_gate"], p["w_up"], p["w_down"]],
        [pl(), pl("data", "model"), pl("data", "model"), pl("model", "data")],
        pl(None, None, "data"), mesh)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def init_embed(init: Init, cfg: ModelConfig) -> Params:
    p = {"embedding": init.dense((cfg.vocab, cfg.d_model), fan_in=cfg.d_model,
                                 spec=("vocab", "embed"))}
    if not cfg.tie_embeddings:
        p["lm_head"] = init.dense((cfg.d_model, cfg.vocab), fan_in=cfg.d_model,
                                  spec=("embed", "vocab"))
    return p


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table.  A DTensor table is gathered on its
    local shards: each rank takes the tokens its vocab rows hold (zeros
    elsewhere), so the result is a sum over the vocab shards (``Partial``)
    and sharded as the table's ``d``; the whole table never moves."""
    table = p["embedding"]
    if shd.is_dtensor(table):
        return _embed_sharded(table, tokens)
    return table[tokens.long()]


def _embed_sharded(table, tokens: torch.Tensor):
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    v0, nv = shd.shard_offsets(table)[0]
    out_pls = [Partial() if isinstance(pl, Shard) and pl.dim == 0
               else Shard(tokens.dim()) if isinstance(pl, Shard) else Replicate()
               for pl in table.placements]

    def body(tab, tok):
        idx = tok.long() - v0
        hit = (idx >= 0) & (idx < nv)
        rows = tab[idx.clamp(0, nv - 1)]
        return torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype))

    return shd.local_call(body, [table, tokens],
                          [table.placements, [Replicate()] * mesh.ndim], out_pls, mesh)


def unembed(p: Params, x: torch.Tensor, tie: bool) -> torch.Tensor:
    w = p["embedding"].T if tie else p["lm_head"]
    return x @ w
