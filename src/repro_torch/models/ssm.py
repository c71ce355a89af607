"""Recurrent mixers: Mamba (Jamba's SSM layers) and xLSTM's cells.

Port of ``repro/models/ssm.py``.  Mamba-1 as in Gu & Dao (``init_mamba``,
``mamba_full``, ``mamba_decode``, ``mamba_init_state``): in-proj ->
causal depthwise conv -> data-dependent (dt, B, C) -> selective
state-space scan -> gate -> out-proj.  The scan runs through
:func:`repro_torch.kernels.ops.ssm_scan`: the CUDA kernel for CUDA
tensors, the plain version on the CPU.

Parameters keep the JAX package's names, shapes and dtypes: ``in_proj
(d, 2di)``, ``conv_w (d_conv, di)``, ``conv_b``, ``x_proj (di, r+2N)``,
``dt_proj (r, di)``, ``dt_bias``, ``A_log (di, N)`` in **float32** even
in a bf16 model, ``D`` and ``out_proj``.  The decode state is O(1) in
sequence length: ``conv (B, d_conv-1, di)`` in the model dtype and
``ssm (B, di, N)`` float32.

xLSTM (Beck et al. 2024; ``init_mlstm``, ``mlstm_full``, ``init_slstm``,
``slstm_full``, ``xlstm_init_state``): the mLSTM cell (matrix memory
``C (B, H, hd, hd)``, normaliser ``n``, stabiliser ``m``) and the sLSTM
cell (per-channel ``c``, ``n``, ``h``, ``m`` with a diagonal recurrence
``r_izfo``), with stabilised exponential gating.  The JAX package runs
them in ``lax.scan`` with no Pallas kernel; here each is a Python loop
over the tokens, one step at a time in float32 with the scan's
arithmetic, so prefill costs a few launches a token a layer.  Decode is
the same function on one token with the carried state.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import sharding as shd
from ..kernels import ops
from .config import ModelConfig
from .layers import Init, Params, Shape

#: a leaf factory ``(shape, dtype, value) -> leaf`` of the state builders
Full = Callable[[Shape, torch.dtype, float], Any]


def _dt_rank(cfg: ModelConfig) -> int:
    m = cfg.mamba
    return m.dt_rank or max(1, math.ceil(cfg.d_model / 16))


def init_mamba(init: Init, cfg: ModelConfig, lead: Shape = ()) -> Params:
    """One Mamba mixer's weights, stacked over ``lead``.

    Each draw uses the JAX package's fan-in, the first axis of the
    unstacked shape; ``A_log`` rows are ``log(1..N)`` (S4D-real).
    """
    m = cfg.mamba
    d = cfg.d_model
    di = d * m.expand
    r = _dt_rank(cfg)
    a = torch.arange(1, m.d_state + 1, dtype=torch.float32, device=init.device)
    return {
        "in_proj": init.dense(lead + (d, 2 * di), fan_in=d, spec=("embed", "ff")),
        "conv_w": init.dense(lead + (m.d_conv, di), fan_in=m.d_conv, spec=("conv", "ff")),
        "conv_b": init.zeros(lead + (di,), ("ff",)),
        "x_proj": init.dense(lead + (di, r + 2 * m.d_state), fan_in=di, spec=("ff", None)),
        "dt_proj": init.dense(lead + (r, di), fan_in=r, spec=(None, "ff")),
        "dt_bias": init.zeros(lead + (di,), ("ff",)),
        "A_log": init.const(torch.log(a).expand(lead + (di, m.d_state)).clone(),
                            ("ff", "state")),
        "D": init.ones(lead + (di,), ("ff",)),
        "out_proj": init.dense(lead + (di, d), fan_in=di, spec=("ff", "embed")),
    }


def mamba_full(
    p: Params,
    cfg: ModelConfig,
    x_in: torch.Tensor,                              # (B, S, d)
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba block.  Returns (out, final_state)."""
    m = cfg.mamba
    B, S, d = x_in.shape
    di = d * m.expand
    r = _dt_rank(cfg)
    xz = x_in @ p["in_proj"]
    x, z = xz[..., :di], xz[..., di:]

    # causal depthwise conv over time (kernel d_conv), in JAX's summation order
    pad = (x.new_zeros((B, m.d_conv - 1, di)) if state is None else state["conv"])
    xp = torch.cat([pad, x], dim=1)
    conv_state = xp[:, xp.shape[1] - (m.d_conv - 1):].contiguous()
    x = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(m.d_conv)) + p["conv_b"]
    x = F.silu(x)

    # on a mesh: dt, B and C summed over the sharded inner dim here, before
    # the ``ff``-sharded dt_proj and dt_bias meet them
    proj = shd.reduce_partial(x @ p["x_proj"])
    dt = F.softplus(proj[..., :r] @ p["dt_proj"] + p["dt_bias"])
    Bm = proj[..., r:r + m.d_state]        # column slices: the kernel reads
    Cm = proj[..., r + m.d_state:]         # them through their strides
    A = -torch.exp(p["A_log"])
    h0 = state["ssm"] if state is not None else None
    y, h = ops.ssm_scan(x, dt, A, Bm, Cm, p["D"], h0=h0)
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, {"conv": conv_state, "ssm": h}


def mamba_decode(
    p: Params, cfg: ModelConfig, x_in: torch.Tensor, state: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token step; state = {conv (B, d_conv-1, di), ssm (B, di, N)}."""
    return mamba_full(p, cfg, x_in, state=state)


def _filler(device: torch.device, full: Optional[Full]) -> Full:
    if full is not None:
        return full
    return lambda shape, dtype, value: torch.full(shape, value, dtype=dtype, device=device)


def mamba_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device, lead: Shape = (),
                     full: Optional[Full] = None) -> Dict[str, torch.Tensor]:
    """Zero decode state for ``batch`` rows, stacked over ``lead``.
    ``full(shape, dtype, value)`` makes each leaf (default: ``torch.full``
    on ``device``)."""
    m = cfg.mamba
    di = cfg.d_model * m.expand
    full = _filler(device, full)
    return {
        "conv": full(lead + (batch, m.d_conv - 1, di), dtype, 0.0),
        "ssm": full(lead + (batch, di, m.d_state), torch.float32, 0.0),
    }


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------
#: the stabiliser's start: ``log_f + m`` loses to any input gate at step 0
M0 = -1e30


def init_mlstm(init: Init, cfg: ModelConfig, lead: Shape = ()) -> Params:
    """One mLSTM cell's weights, stacked over ``lead`` (fan-in: the first
    axis of each unstacked shape)."""
    x = cfg.xlstm
    d = cfg.d_model
    di = int(d * x.proj_factor)
    return {
        "up_proj": init.dense(lead + (d, 2 * di), fan_in=d, spec=("embed", "ff")),
        "wq": init.dense(lead + (di, di), fan_in=di, spec=("ff", None)),
        "wk": init.dense(lead + (di, di), fan_in=di, spec=("ff", None)),
        "wv": init.dense(lead + (di, di), fan_in=di, spec=("ff", None)),
        "w_i": init.dense(lead + (di, x.n_heads), fan_in=di, spec=("ff", None)),
        "w_f": init.dense(lead + (di, x.n_heads), fan_in=di, spec=("ff", None)),
        "w_o": init.dense(lead + (di, di), fan_in=di, spec=("ff", None)),
        "down_proj": init.dense(lead + (di, d), fan_in=di, spec=("ff", "embed")),
    }


def mlstm_full(
    p: Params,
    cfg: ModelConfig,
    x_in: torch.Tensor,                              # (B, S, d)
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """mLSTM over S tokens from ``state`` (fresh when ``None``).

    The projections run in the model dtype; the gates, the cell and its
    state in float32, step by step as JAX's ``lax.scan``: ``log_f =
    -softplus(-f_pre)``, ``m_new = max(log_f + m, i_pre)``, ``C = f C + i
    v k^T``, ``n = f n + i k``, ``y = C q / max(|n . q|, 1)``.  Returns
    (out, the final ``{"C", "n", "m"}``).
    """
    xc = cfg.xlstm
    B, S, d = x_in.shape
    di = int(d * xc.proj_factor)
    H = xc.n_heads
    hd = di // H
    up = x_in @ p["up_proj"]
    u, z = up[..., :di], up[..., di:]
    q = (u @ p["wq"]).reshape(B, S, H, hd).float()
    k = ((u @ p["wk"]).reshape(B, S, H, hd) / math.sqrt(hd)).float()
    v = (u @ p["wv"]).reshape(B, S, H, hd).float()
    i_pre = (u @ p["w_i"]).float()                       # (B, S, H)
    log_f = -F.softplus(-(u @ p["w_f"]).float())         # log sigmoid(f)
    if state is None:
        st = xlstm_init_state(cfg, B, False, x_in.device)
        C, n, m = st["C"], st["n"], st["m"]
    else:
        C, n, m = state["C"], state["n"], state["m"]
    ys = []
    for t in range(S):
        qt, kt, it = q[:, t], k[:, t], i_pre[:, t]
        lf_m = log_f[:, t] + m
        m = torch.maximum(lf_m, it)
        i_g = torch.exp(it - m)
        f_g = torch.exp(lf_m - m)
        C = (f_g[..., None, None] * C
             + i_g[..., None, None] * (v[:, t, :, :, None] * kt[..., None, :]))
        n = f_g[..., None] * n + i_g[..., None] * kt
        denom = torch.clamp_min(torch.einsum("bhd,bhd->bh", n, qt).abs(), 1.0)
        ys.append(torch.einsum("bhde,bhe->bhd", C, qt) / denom[..., None])
    y = shd.merge_heads(torch.stack(ys, dim=1)).to(x_in.dtype)
    y = y * F.silu(z)
    out = (y * torch.sigmoid(u @ p["w_o"])) @ p["down_proj"]
    return out, {"C": C, "n": n, "m": m}


def init_slstm(init: Init, cfg: ModelConfig, lead: Shape = ()) -> Params:
    """One sLSTM cell's weights; the diagonal recurrence ``r_izfo`` starts
    at zeros, as in JAX."""
    d = cfg.d_model
    return {
        "w_izfo": init.dense(lead + (d, 4 * d), fan_in=d, spec=("embed", "ff")),
        "r_izfo": init.zeros(lead + (4 * d,), ("ff",)),
        "out_proj": init.dense(lead + (d, d), fan_in=d, spec=(None, "embed")),
    }


def slstm_full(
    p: Params,
    cfg: ModelConfig,
    x_in: torch.Tensor,                              # (B, S, d)
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """sLSTM over S tokens from ``state``: the input projection in the
    model dtype, then float32 steps as JAX's scan (the recurrence adds
    ``[h, h, h, h] * r_izfo`` to the pre-activations; ``h = sigmoid(o) c /
    max(n, 1)``).  Returns (out, the final ``{"c", "n", "h", "m"}``)."""
    B, S, d = x_in.shape
    pre = (x_in @ p["w_izfo"]).float()                   # (B, S, 4d)
    if state is None:
        st = xlstm_init_state(cfg, B, True, x_in.device)
        c, n, h, m = st["c"], st["n"], st["h"], st["m"]
    else:
        c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    r = p["r_izfo"].float()
    ys = []
    for t in range(S):
        rec = torch.cat([h, h, h, h], dim=-1) * r[None]
        zi, zz, zf, zo = torch.split(pre[:, t] + rec, d, dim=-1)
        log_f = -F.softplus(-zf)
        lf_m = log_f + m
        m = torch.maximum(lf_m, zi)
        i_g = torch.exp(zi - m)
        f_g = torch.exp(lf_m - m)
        c = f_g * c + i_g * torch.tanh(zz)
        n = f_g * n + i_g
        h = torch.sigmoid(zo) * c / torch.clamp_min(n, 1.0)
        ys.append(h)
    y = torch.stack(ys, dim=1).to(x_in.dtype)
    return y @ p["out_proj"], {"c": c, "n": n, "h": h, "m": m}


def xlstm_init_state(cfg: ModelConfig, batch: int, is_slstm: bool,
                     device: torch.device, lead: Shape = (),
                     full: Optional[Full] = None) -> Dict[str, torch.Tensor]:
    """Fresh float32 state of one cell for ``batch`` rows, stacked over
    ``lead``: sLSTM ``c, n, h, m (B, d)`` (``n`` ones), mLSTM ``C (B, H,
    hd, hd)``, ``n (B, H, hd)``, ``m (B, H)``; ``m`` is :data:`M0`.
    ``full(shape, dtype, value)`` makes each leaf (default: ``torch.full``
    on ``device``)."""
    make = _filler(device, full)

    def full(shape, value):
        return make(lead + shape, torch.float32, value)

    d = cfg.d_model
    x = cfg.xlstm
    if is_slstm:
        return {"c": full((batch, d), 0.0), "n": full((batch, d), 1.0),
                "h": full((batch, d), 0.0), "m": full((batch, d), M0)}
    di = int(d * x.proj_factor)
    hd = di // x.n_heads
    return {"C": full((batch, x.n_heads, hd, hd), 0.0),
            "n": full((batch, x.n_heads, hd), 0.0),
            "m": full((batch, x.n_heads), M0)}
