"""Transformer layers of the paged serving path: plain functions on tensors.

The subset of ``repro/models/layers.py`` the dense family's paged path
runs: ``embed``, ``rmsnorm``, ``rope``, ``_proj_qkv``, ``mlp`` and
``unembed``, with the ``init_*`` functions of their weights.  Parameters
are plain nested dicts of tensors with the JAX package's names, shapes
and dtypes; the matrix products stay ``x @ w`` (outside any kernel, as
the JAX package left them to XLA), and RMSNorm goes through
:mod:`repro_torch.kernels.ops` (the CUDA kernel for CUDA tensors).

Weights are drawn as in the JAX package — normal with
``std = 1/sqrt(fan_in)``, drawn in float32 and cast to the model dtype —
but from a seeded ``torch.Generator`` on the target device, so a
full-width model is initialised on the card.  The values differ from
JAX's for the same seed; the tests bridge JAX's weights instead.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig

Params = Dict[str, Any]
Shape = Tuple[int, ...]


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

    def dense(self, shape: Shape, fan_in: int) -> torch.Tensor:
        std = 1.0 / math.sqrt(max(1, fan_in))
        w = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return (w * std).to(self.dtype)

    def ones(self, shape: Shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, shape: Shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def init_rmsnorm(init: Init, d: int, lead: Shape = ()) -> torch.Tensor:
    return init.ones(lead + (d,))


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
def init_attention(init: Init, cfg: ModelConfig, lead: Shape = ()) -> Params:
    d, hd = cfg.d_model, cfg.hd
    h, k = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": init.dense(lead + (d, h * hd), fan_in=d),
        "wk": init.dense(lead + (d, k * hd), fan_in=d),
        "wv": init.dense(lead + (d, k * hd), fan_in=d),
        "wo": init.dense(lead + (h * hd, d), fan_in=h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = init.zeros(lead + (h * hd,))
        p["bk"] = init.zeros(lead + (k * hd,))
        p["bv"] = init.zeros(lead + (k * hd,))
    return p


def _proj_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor, kv_src: torch.Tensor):
    B, S, _ = x.shape
    Skv = kv_src.shape[1]
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    kk = (kv_src @ p["wk"]).reshape(B, Skv, k, hd)
    v = (kv_src @ p["wv"]).reshape(B, Skv, k, hd)
    if "bq" in p:
        q = q + p["bq"].reshape(1, 1, h, hd)
        kk = kk + p["bk"].reshape(1, 1, k, hd)
        v = v + p["bv"].reshape(1, 1, k, hd)
    return q, kk, v


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------
def init_mlp(init: Init, d: int, ff: int, lead: Shape = ()) -> Params:
    return {
        "w_gate": init.dense(lead + (d, ff), fan_in=d),
        "w_up": init.dense(lead + (d, ff), fan_in=d),
        "w_down": init.dense(lead + (ff, d), fan_in=ff),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def init_embed(init: Init, cfg: ModelConfig) -> Params:
    p = {"embedding": init.dense((cfg.vocab, cfg.d_model), fan_in=cfg.d_model)}
    if not cfg.tie_embeddings:
        p["lm_head"] = init.dense((cfg.d_model, cfg.vocab), fan_in=cfg.d_model)
    return p


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens.long()]


def unembed(p: Params, x: torch.Tensor, tie: bool) -> torch.Tensor:
    w = p["embedding"].T if tie else p["lm_head"]
    return x @ w
