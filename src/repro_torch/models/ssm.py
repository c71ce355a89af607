"""Mamba layers of the hybrid family (Jamba's SSM layers).

Port of the Mamba half of ``repro/models/ssm.py``: ``init_mamba``,
``mamba_full``, ``mamba_decode`` and ``mamba_init_state``.  Mamba-1 as
in Gu & Dao: in-proj -> causal depthwise conv -> data-dependent
(dt, B, C) -> selective state-space scan -> gate -> out-proj.  The scan
runs through :func:`repro_torch.kernels.ops.ssm_scan`: the CUDA kernel
for CUDA tensors, the plain version on the CPU.

Parameters keep the JAX package's names, shapes and dtypes: ``in_proj
(d, 2di)``, ``conv_w (d_conv, di)``, ``conv_b``, ``x_proj (di, r+2N)``,
``dt_proj (r, di)``, ``dt_bias``, ``A_log (di, N)`` in **float32** even
in a bf16 model, ``D`` and ``out_proj``.  The decode state is O(1) in
sequence length: ``conv (B, d_conv-1, di)`` in the model dtype and
``ssm (B, di, N)`` float32.  The xLSTM cells of the same JAX module are
not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import Init, Params, Shape


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
        "in_proj": init.dense(lead + (d, 2 * di), fan_in=d),
        "conv_w": init.dense(lead + (m.d_conv, di), fan_in=m.d_conv),
        "conv_b": init.zeros(lead + (di,)),
        "x_proj": init.dense(lead + (di, r + 2 * m.d_state), fan_in=di),
        "dt_proj": init.dense(lead + (r, di), fan_in=r),
        "dt_bias": init.zeros(lead + (di,)),
        "A_log": torch.log(a).expand(lead + (di, m.d_state)).clone(),
        "D": init.ones(lead + (di,)),
        "out_proj": init.dense(lead + (di, d), fan_in=di),
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

    proj = x @ p["x_proj"]
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


def mamba_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device, lead: Shape = ()) -> Dict[str, torch.Tensor]:
    """Zero decode state for ``batch`` rows, stacked over ``lead``."""
    m = cfg.mamba
    di = cfg.d_model * m.expand
    return {
        "conv": torch.zeros(lead + (batch, m.d_conv - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, di, m.d_state), dtype=torch.float32,
                           device=device),
    }
