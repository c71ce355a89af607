"""Pieces the references share: matrix products in float32 or float8,
RMSNorm, RoPE and causal softmax attention, all in plain PyTorch.

Computed layer by layer: a weight is cast to float32 (or rounded through
float8 e4m3) when its layer runs, so a float32 copy of the whole model is
never held.  TF32 is switched off wherever this module is imported, so a
float32 product on the card is a float32 product.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (the largest magnitude of each slice maps to 448)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def linear(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """``x @ w`` in float32; in ``"fp8"`` both sides are first rounded
    through e4m3 (rows of ``x``, columns of ``w`` scaled apart), as an
    fp8 GEMM with float32 accumulation computes; in ``"bf16"`` (a witness,
    not the reference) a bf16 product with a bf16 result, as the served
    dtype computes it."""
    if mode == "bf16":
        return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
    x = x.float()
    w = w.float()
    if mode == "fp8":
        x = _fp8(x, -1)
        w = _fp8(w, -2)
    elif mode != "f32":
        raise ValueError(f"mode must be 'f32', 'fp8' or 'bf16', got {mode!r}")
    return x @ w


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` ``(S, heads, dim)`` at positions 0..S-1,
    rotating the two halves of ``dim`` (the NeoX form)."""
    S, _, dim = x.shape
    half = dim // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Softmax attention of ``q`` ``(S, H, dk)`` over ``k`` ``(S, K, dk)``
    and ``v`` ``(S, K, dv)``, causal, key heads shared by ``H / K`` query
    heads; returns ``(S, H * dv)``."""
    S, H, _ = q.shape
    K = k.shape[1]
    if H != K:
        k = k.repeat_interleave(H // K, dim=1)
        v = v.repeat_interleave(H // K, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(S, -1)


def gated_mlp(x: torch.Tensor, w: dict, mode: str) -> torch.Tensor:
    """SiLU-gated MLP: ``(silu(x Wg) * (x Wu)) Wd``."""
    g = linear(x, w["w_gate"], mode)
    u = linear(x, w["w_up"], mode)
    return linear(torch.nn.functional.silu(g) * u, w["w_down"], mode)


def layers(w: dict):
    """Every decoder layer's weights in order: the unstacked
    ``prefix_{i}`` layers, then superblock by superblock each pattern
    position of ``blocks``."""
    i = 0
    while f"prefix_{i}" in w:
        yield w[f"prefix_{i}"]
        i += 1
    blocks = w.get("blocks", {})
    if not blocks:
        return
    n_sb = _first_leaf(blocks["0"]).shape[0]
    for s in range(n_sb):
        for j in range(len(blocks)):
            yield _index(blocks[str(j)], s)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _index(tree, s: int):
    return {k: _index(v, s) if isinstance(v, dict) else v[s] for k, v in tree.items()}


def head(w: dict, cfg: dict, h: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    """Logits of final-norm hidden states ``h`` ``(n, d)``."""
    table = w["embedding"].T if cfg.get("tie_word_embeddings") else w["lm_head"]
    return linear(h, table, mode)
