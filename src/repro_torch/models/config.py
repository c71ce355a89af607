"""Model configuration schema for the architecture zoo (PyTorch port).

A copy of the JAX package's schema with the array-library import swapped:
one :class:`ModelConfig` describes any of the 10 assigned architectures
(dense GQA, VLM, hybrid Mamba/attention, enc-dec audio, MoE, MLA, xLSTM),
and :attr:`ModelConfig.tdtype` names the compute dtype as a ``torch``
dtype.  `repro_torch.configs.<arch>` files instantiate these with the
exact published numbers plus a reduced smoke variant.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # always-on shared experts (DeepSeek/Kimi)
    layer_period: int = 1       # MoE every k-th layer (Jamba: 2)
    first_dense: int = 0        # leading dense layers (DeepSeek: 1)
    d_ff_dense: int = 0         # ff width of the dense layers
    capacity_factor: float = 1.25
    impl: str = "dense"         # "dense" (one-hot oracle) | "ep" (shard_map)
    combine_dtype: str = "float32"   # psum dtype for expert combine
    dispatch_dtype: str = "bfloat16" # a2a payload ("int8" = quantized
                                     # dispatch, DeepSeek-V3 style)
    dedup_dispatch: bool = False     # send each token row once per dest
                                     # shard (not once per expert)
    shard_groups: int = 0            # >0: token may route to experts on at
                                     # most this many shards (DeepSeek
                                     # node-limited routing analogue)


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0        # 0 = no q compression (V2-Lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8        # sLSTM block every k-th layer (others mLSTM)
    proj_factor: float = 2.0    # mLSTM up-projection
    n_heads: int = 4
    chunk: int = 64             # chunkwise-parallel mLSTM chunk length


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder of enc-dec (whisper) / vision tower stub of VLMs."""

    n_layers: int = 4
    n_ctx: int = 1500           # precomputed frames / patches (stub input)
    d_model: int = 0            # 0 -> same as decoder


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | vlm | hybrid | audio | moe | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False      # Qwen
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None

    # layer pattern --------------------------------------------------------
    attn_period: int = 1        # hybrid: attention every k-th layer (Jamba 8)
    cross_attn_period: int = 0  # vlm: cross-attn layer every k-th (0 = none)

    # runtime knobs ---------------------------------------------------------
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"   # "int8" enables quantized KV
    decode_mlp: str = "auto"           # "ws" = weight-stationary shard_map
                                       # MLP for decode (activation psums
                                       # instead of per-step weight gathers)
    scan_layers: bool = True
    remat: str = "full"         # "none" | "full" — activation checkpointing
    max_seq: int = 8192
    sub_quadratic: bool = False # can run long_500k

    # ------------------------------------------------------------------ api
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def tdtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid pattern: Jamba places attention once per `attn_period`."""
        if self.attn_period <= 1:
            return True
        return (i % self.attn_period) == (self.attn_period // 2)

    def is_cross_layer(self, i: int) -> bool:
        return self.cross_attn_period > 0 and (i % self.cross_attn_period) == (
            self.cross_attn_period - 1
        )

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.first_dense:
            return False
        return ((i - self.moe.first_dense) % self.moe.layer_period) == 0

    # -- parameter counting (roofline MODEL_FLOPS) ---------------------------
    def param_count(self) -> Tuple[int, int]:
        """(total_params, active_params) — active differs for MoE."""
        d, hd = self.d_model, self.hd
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        total = active = 0
        # embeddings (+ untied head)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total += emb
        active += emb
        enc_params = 0
        if self.encoder is not None:
            ed = self.encoder.d_model or d
            per = 4 * ed * ed + 3 * ed * self.d_ff if self.d_ff else 4 * ed * ed
            enc_params = self.encoder.n_layers * per
            total += enc_params
            active += enc_params
        for i in range(self.n_layers):
            layer_t = layer_a = 0
            if self.family == "ssm" and self.xlstm is not None:
                f = self.xlstm.proj_factor
                di = int(d * f)
                layer_t = 2 * d * di + di * d + 3 * di * self.xlstm.n_heads * 4
                layer_t += 4 * di * (di // max(1, self.xlstm.n_heads))
                layer_a = layer_t
            else:
                if self.is_attn_layer(i):
                    if self.mla is not None:
                        m = self.mla
                        qdim = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                        layer_t += d * qdim                       # q proj
                        layer_t += d * (m.kv_lora_rank + m.rope_head_dim)
                        layer_t += m.kv_lora_rank * self.n_heads * (
                            m.nope_head_dim + m.v_head_dim
                        )
                        layer_t += self.n_heads * m.v_head_dim * d
                    else:
                        layer_t += d * q + 2 * d * kv + q * d
                elif self.mamba is not None:
                    di = d * self.mamba.expand
                    layer_t += 2 * d * di + di * d
                    layer_t += di * (2 * self.mamba.d_state + self.mamba.d_conv + 2)
                layer_a += layer_t
                if self.is_moe_layer(i):
                    m = self.moe
                    e = 3 * d * m.d_ff_expert
                    layer_t += (m.n_experts + m.n_shared) * e + d * m.n_experts
                    layer_a += (m.top_k + m.n_shared) * e + d * m.n_experts
                elif self.moe is not None and i < self.moe.first_dense:
                    ffd = 3 * d * (self.moe.d_ff_dense or self.d_ff)
                    layer_t += ffd
                    layer_a += ffd
                elif self.d_ff > 0:
                    ff = 3 * d * self.d_ff
                    layer_t += ff
                    layer_a += ff
                if self.is_cross_layer(i):
                    layer_t += 2 * d * kv + d * q + q * d
                    layer_a += 2 * d * kv + d * q + q * d
            total += layer_t
            active += layer_a
        return total, active

    def kv_bytes_per_token(self) -> int:
        """Decode-cache bytes per token (per request) — drives Eq. 2 l(b)."""
        b = {"bfloat16": 2, "int8": 1, "float32": 4}[self.kv_cache_dtype]
        if self.family == "ssm":
            return 0  # constant-size recurrent state
        if self.mla is not None:
            per_layer = self.mla.kv_lora_rank + self.mla.rope_head_dim
        else:
            per_layer = 2 * self.n_kv_heads * self.hd
        n_attn = sum(1 for i in range(self.n_layers) if self.is_attn_layer(i))
        if self.family == "hybrid":
            n_attn = sum(
                1 for i in range(self.n_layers) if self.is_attn_layer(i)
            )
        return n_attn * per_layer * b

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assignment: 4 shapes, shared across all 10 archs)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "quadratic attention at 524k ctx (skip per assignment)"
    return True, ""
