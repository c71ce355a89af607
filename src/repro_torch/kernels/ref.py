"""Plain PyTorch versions of the ported kernels (the ``ref.py`` contract).

Each function repeats, op for op, the JAX package's oracle of the same
name (``repro/kernels/ref.py``): float32 math, additive ``NEG_INF``
masks, a softmax over the gathered dense view.  They are the semantics
the hand-written CUDA kernels are held against, and the path the model
takes for tensors that lie on the CPU.

Like their JAX originals, the attention versions mask *additively*, so
a NaN in a masked slot still reaches the output: they are not NaN-safe.
The CUDA kernels replace masked scores and zero masked V rows instead;
a NaN check therefore compares a kernel with itself on clean versus
poisoned pages, never with these functions.

The backward versions (:func:`attention_lse_ref`,
:func:`attention_bwd_ref`, :func:`rmsnorm_bwd_ref`,
:func:`ssm_scan_bwd_ref`) write the gradients
out formula by formula in float32, without autograd: they are what the
backward kernels are held against on the card.  The model's CPU path
never calls them; there autograd differentiates the forward versions,
as JAX differentiates its jnp oracles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Attention (prefill/train): GQA + causal
# ---------------------------------------------------------------------------
def attention_ref(
    q: torch.Tensor,            # (B, S_q, H, hd)
    k: torch.Tensor,            # (B, S_k, K, hd)
    v: torch.Tensor,            # (B, S_k, K, hd)
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,          # absolute position of q[0] (cached prefix len)
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid kv length per batch
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    hd_v = v.shape[-1]
    g = H // K
    scale = scale if scale is not None else hd ** -0.5
    dev = q.device
    qf = q.float() * scale
    qf = qf.reshape(B, Sq, K, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    mask = torch.zeros((B, 1, 1, Sq, Sk), dtype=torch.float32, device=dev)
    if causal:
        qpos = torch.arange(Sq, device=dev)[:, None] + q_offset
        kpos = torch.arange(Sk, device=dev)[None, :]
        causal_mask = torch.where(kpos > qpos, NEG_INF, 0.0)
        mask = mask + causal_mask[None, None, None]
    if kv_len is not None:
        valid = torch.arange(Sk, device=dev)[None, :] < kv_len.to(dev)[:, None]
        mask = mask + torch.where(valid, 0.0, NEG_INF)[:, None, None, None, :]
    w = torch.softmax(logits + mask, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, hd_v).to(q.dtype)


def _attention_scores(q, k, causal, scale):
    """Scaled f32 scores ``(B, K, g, Sq, Sk)`` with the additive causal mask."""
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    g = H // K
    qf = (q.float() * scale).reshape(B, Sq, K, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = s + torch.where(kpos > qpos, NEG_INF, 0.0)
    return s


def attention_lse_ref(
    q: torch.Tensor,            # (B, S_q, H, hd)
    k: torch.Tensor,            # (B, S_k, K, hd)
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The row log-sum-exp of the scaled, masked scores: ``(B, H, Sq)``
    float32, natural log (what the flash kernel's optional LSE output
    holds)."""
    B, Sq, H, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    s = _attention_scores(q, k, causal, scale)
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def attention_bwd_ref(
    q: torch.Tensor,            # (B, S_q, H, hd)
    k: torch.Tensor,            # (B, S_k, K, hd)
    v: torch.Tensor,            # (B, S_k, K, hd_v)
    o: torch.Tensor,            # (B, S_q, H, hd_v) the forward's output
    lse: torch.Tensor,          # (B, H, S_q) f32 row log-sum-exp
    do: torch.Tensor,           # (B, S_q, H, hd_v) gradient of o
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of :func:`attention_ref` (no ``kv_len``
    or ``q_offset``), in q's, k's and v's dtypes.

    Float32, formula by formula: ``P = exp(S - lse)``, ``dV = P^T dO``,
    ``dP = dO V^T``, ``D = rowsum(dO * O)``, ``dS = P * (dP - D)``,
    ``dQ = dS K * scale``, ``dK = dS^T Q * scale``; a kv head's ``dK``
    and ``dV`` sum over its group of query heads.
    """
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    hd_v = v.shape[-1]
    g = H // K
    scale = scale if scale is not None else hd ** -0.5
    s = _attention_scores(q, k, causal, scale)                    # (B, K, g, Sq, Sk)
    p = torch.exp(s - lse.float().reshape(B, K, g, Sq, 1))
    dof = do.float().reshape(B, Sq, K, g, hd_v)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    dd = (dof * o.float().reshape(B, Sq, K, g, hd_v)).sum(-1)     # (B, Sq, K, g)
    ds = p * (dp - dd.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.float().reshape(B, Sq, K, g, hd)) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


# ---------------------------------------------------------------------------
# Decode attention: single query token vs KV cache with valid lengths
# ---------------------------------------------------------------------------
def decode_attention_ref(
    q: torch.Tensor,            # (B, H, hd)
    k_cache: torch.Tensor,      # (B, S, K, hd)
    v_cache: torch.Tensor,      # (B, S, K, hd)
    lengths: torch.Tensor,      # (B,) int — valid cache entries
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, H, hd = q.shape
    _, S, K, _ = k_cache.shape
    hd_v = v_cache.shape[-1]
    g = H // K
    scale = scale if scale is not None else hd ** -0.5
    qf = (q.float() * scale).reshape(B, K, g, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    valid = (
        torch.arange(S, device=q.device)[None, :]
        < lengths.to(q.device)[:, None]
    )                                                          # (B, S)
    logits = logits + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.float())
    return out.reshape(B, H, hd_v).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged decode attention (vLLM-style PagedAttention)
# ---------------------------------------------------------------------------
def gather_pages(
    pages: torch.Tensor,         # (P, page_size, K, hd) physical page pool
    block_tables: torch.Tensor,  # (B, pages_per_seq) int page ids
) -> torch.Tensor:
    """Materialize the dense (B, S, K, hd) view a block table describes.

    Token t of request b lives at (block_tables[b, t // ps], t % ps);
    gathering page-by-page therefore reconstructs positions in order.
    """
    P, ps, K, hd = pages.shape
    B, npp = block_tables.shape
    flat = pages.reshape(P * ps, K, hd)
    bt = block_tables.to(device=pages.device, dtype=torch.long)
    tok = bt[:, :, None] * ps + torch.arange(ps, device=pages.device)[None, None, :]
    return flat[tok.reshape(B, npp * ps)]


def paged_decode_attention_ref(
    q: torch.Tensor,             # (B, H, hd)
    k_pages: torch.Tensor,       # (P, page_size, K, hd)
    v_pages: torch.Tensor,       # (P, page_size, K, hd_v)
    block_tables: torch.Tensor,  # (B, pages_per_seq) int
    lengths: torch.Tensor,       # (B,) int — valid tokens (incl. current)
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,  # (P, page_size, K) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if k_scales is not None:
        k_pages = dequantize_pages_ref(k_pages, k_scales)
        v_pages = dequantize_pages_ref(v_pages, v_scales)
    k_dense = gather_pages(k_pages, block_tables)
    v_dense = gather_pages(v_pages, block_tables)
    return decode_attention_ref(q, k_dense, v_dense, lengths, scale=scale)


# ---------------------------------------------------------------------------
# Paged chunked-prefill attention: C chunk queries of a single request vs
# the context pages named by its block table (history + in-chunk segment,
# both already scattered into the pool)
# ---------------------------------------------------------------------------
def paged_prefill_attention_ref(
    q: torch.Tensor,            # (C, H, hd) — one request's chunk queries
    k_pages: torch.Tensor,      # (P, page_size, K, hd)
    v_pages: torch.Tensor,      # (P, page_size, K, hd_v)
    block_table: torch.Tensor,  # (pages_per_seq,) int
    past: int,                  # prompt tokens already prefilled (chunk offset)
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,  # (P, page_size, K) f32
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if k_scales is not None:
        k_pages = dequantize_pages_ref(k_pages, k_scales)
        v_pages = dequantize_pages_ref(v_pages, v_scales)
    C = q.shape[0]
    ps = k_pages.shape[1]
    ctx = past + C
    n_ctx_pages = -(-ctx // ps)
    bt = block_table[None, :n_ctx_pages]
    k_ctx = gather_pages(k_pages, bt)            # (1, n_ctx_pages*ps, K, hd)
    v_ctx = gather_pages(v_pages, bt)
    kv_len = torch.tensor([ctx], dtype=torch.int32, device=q.device)
    out = attention_ref(
        q[None], k_ctx, v_ctx, causal=True, scale=scale,
        q_offset=past, kv_len=kv_len,
    )
    return out[0]


# ---------------------------------------------------------------------------
# int8 KV-page quantization: symmetric per (token-slot, kv-head) scales,
# stored page-major alongside the pools ("per-page scale pools")
# ---------------------------------------------------------------------------
def quantize_kv_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize K/V values to int8 with per (..., kv-head) symmetric scales.

    ``x`` is ``(..., K, hd)`` (float32 or bfloat16, upcast to float32
    first); returns ``(q int8 (..., K, hd), scales float32 (..., K))``
    with ``scale = max(amax, 1e-8) / 127`` over the head dim, then
    round-half-to-even of ``x / scale``, clipped to +-127: bit for bit
    the JAX package's spec.  Each token is quantized once, at write time,
    from its exact value, so page contents are a pure function of the
    tokens they hold.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.maximum(amax, amax.new_tensor(1e-8)) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_pages_ref(
    pages: torch.Tensor,    # (P, page_size, K, hd) int8
    scales: torch.Tensor,   # (P, page_size, K) f32
) -> torch.Tensor:
    """Reconstruct float32 pages from an int8 pool and its scale pool."""
    return pages.float() * scales[..., None]


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_ref(
    x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def rmsnorm_bwd_ref(
    x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(dx, dgamma)`` of :func:`rmsnorm_ref`, float32 math,
    cast to x's and gamma's dtypes.

    With ``r = rsqrt(mean(x^2) + eps)`` and ``u = dy * gamma`` (a row of d):
    ``dx = r * u - x * r^3 * mean(u * x)`` and ``dgamma = sum_rows(dy * x * r)``.
    """
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    dyf = dy.float().reshape(-1, d)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    u = dyf * gamma.float()
    dx = r * u - xf * (r * r * r) * torch.mean(u * xf, dim=-1, keepdim=True)
    dgamma = torch.sum(dyf * xf * r, dim=0)
    return dx.reshape(x.shape).to(x.dtype), dgamma.to(gamma.dtype)


# ---------------------------------------------------------------------------
# Mamba selective scan (SSM):  h_t = dA_t * h_{t-1} + dB_t x_t ;  y = C_t . h
# ---------------------------------------------------------------------------
def ssm_scan_ref(
    x: torch.Tensor,            # (B, T, D)  post-conv activations
    dt: torch.Tensor,           # (B, T, D)  softplus'd step sizes
    A: torch.Tensor,            # (D, N)     negative decay matrix
    Bm: torch.Tensor,           # (B, T, N)  input matrix
    Cm: torch.Tensor,           # (B, T, N)  output matrix
    D: torch.Tensor,            # (D,)       skip
    h0: Optional[torch.Tensor] = None,  # (B, D, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, D) in x's dtype, h_T (B, D, N) float32).

    float32 state math, one step of T at a time (JAX's ``lax.scan``).
    """
    Bsz, T, Dd = x.shape
    N = A.shape[1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    Af = A.float()
    h = (torch.zeros((Bsz, Dd, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(T):
        dA = torch.exp(dtf[:, t, :, None] * Af[None])              # (B, D, N)
        dBx = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D.float()[None, None, :]
    return y.to(x.dtype), h


def ssm_scan_bwd_ref(
    x: torch.Tensor,            # (B, T, D)
    dt: torch.Tensor,           # (B, T, D)
    A: torch.Tensor,            # (D, N)
    Bm: torch.Tensor,           # (B, T, N)
    Cm: torch.Tensor,           # (B, T, N)
    D: torch.Tensor,            # (D,)
    dy: torch.Tensor,           # (B, T, D) gradient of y
    h0: Optional[torch.Tensor] = None,   # (B, D, N)
    dhT: Optional[torch.Tensor] = None,  # (B, D, N) gradient of h_T
) -> Tuple[torch.Tensor, ...]:
    """Gradients ``(dx, ddt, dA, dB, dC, dD, dh0)`` of :func:`ssm_scan_ref`
    (``dh0`` None when ``h0`` is), in the inputs' dtypes (dA and dh0
    float32).

    Float32, the reverse recurrence written out: with ``a_t = exp(dt_t A)``
    and ``g_t = dy_t C_t + a_{t+1} g_{t+1}`` (``dh_T`` at the end, zeros
    when None): ``dx_t = D dy_t + dt_t sum_n g_t B_t``, ``ddt_t = x_t
    sum_n g_t B_t + sum_n g_t A a_t h_{t-1}``, ``dB_t = sum_d g_t dt_t
    x_t``, ``dC_t = sum_d dy_t h_t``, ``dA = sum_{b,t} g_t dt_t a_t
    h_{t-1}``, ``dD = sum_{b,t} dy_t x_t``, ``dh0 = a_1 g_1``.  Every state
    is kept (B * T * D * N floats).
    """
    Bsz, T, Dd = x.shape
    N = A.shape[1]
    xf, dtf, Bf, Cf, dyf = x.float(), dt.float(), Bm.float(), Cm.float(), dy.float()
    Af = A.float()
    h = (torch.zeros((Bsz, Dd, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs, decays = [h], []
    for t in range(T):
        a = torch.exp(dtf[:, t, :, None] * Af[None])               # (B, D, N)
        h = a * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        decays.append(a)
        hs.append(h)
    G = torch.zeros_like(h) if dhT is None else dhT.float()
    dx = torch.empty_like(xf)
    ddt = torch.empty_like(xf)
    dB = torch.empty_like(Bf)
    dC = torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    for t in reversed(range(T)):
        g = dyf[:, t, :, None] * Cf[:, t, None, :] + G              # dL/dh_t
        gb = (g * Bf[:, t, None, :]).sum(-1)                        # (B, D)
        w = g * decays[t] * hs[t]                                   # g a_t h_{t-1}
        dx[:, t] = D.float() * dyf[:, t] + dtf[:, t] * gb
        ddt[:, t] = xf[:, t] * gb + (w * Af[None]).sum(-1)
        dA += (w * dtf[:, t, :, None]).sum(0)
        dB[:, t] = (g * (dtf[:, t] * xf[:, t])[..., None]).sum(1)
        dC[:, t] = (dyf[:, t, :, None] * hs[t + 1]).sum(1)
        G = decays[t] * g
    dD = (dyf * xf).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA, dB.to(Bm.dtype), dC.to(Cm.dtype),
            dD.to(D.dtype), None if h0 is None else G)
