"""Mamba selective scan: the wrapper of the hand-written CUDA kernel.

Replaces the JAX package's Pallas kernel (``repro/kernels/ssm_scan.py``);
the kernel is ``csrc/ssm_scan.cu``.  It computes, with a float32 state
carried over T,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   y_t = h_t . C_t + D x_t

and returns ``(y, h_T)``.  Unlike the TPU kernel, which sends ragged T or
D to the plain version, the CUDA kernel takes any ``T >= 1`` and any
channel count (the ragged tail is masked).

x, dt, B and C are read through their strides: the Mamba layer's B and C
are column slices of one projection and go in as they are.

The wrapper takes CUDA tensors only: it checks what the kernel accepts,
allocates the outputs, takes the lanes a channel from
:func:`repro_torch.kernels._build.ssm_scan_lanes`, launches on the
current stream, raises if the launch was refused and counts its launches
in ``ssm_scan.launches``.  The plain version is
:func:`repro_torch.kernels.ref.ssm_scan_ref`, which serves the CPU
through :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: largest state size N the kernel keeps in registers (Jamba: 16)
MAX_STATE = _build.SSM_MAX_STATE
#: most sequences one launch takes (the grid's second axis)
MAX_BATCH = 65535


def ssm_scan(
    x: torch.Tensor,       # (B, T, D)
    dt: torch.Tensor,      # (B, T, D)
    A: torch.Tensor,       # (D, N) float32
    Bm: torch.Tensor,      # (B, T, N)
    Cm: torch.Tensor,      # (B, T, N)
    D: torch.Tensor,       # (D,)
    h0: Optional[torch.Tensor] = None,   # (B, D, N) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan; the semantics of ``ref.ssm_scan_ref``.

    Parameters
    ----------
    x, dt : torch.Tensor
        ``(B, T, D)`` activations and step sizes, float32 or bfloat16.
    A : torch.Tensor
        ``(D, N)`` float32 decay matrix, ``N <= MAX_STATE``.
    Bm, Cm : torch.Tensor
        ``(B, T, N)`` input and output matrices, in x's dtype.
    D : torch.Tensor
        ``(D,)`` skip weights, in x's dtype.
    h0 : torch.Tensor, optional
        ``(B, D, N)`` float32 initial state; ``None`` means zeros.

    Returns
    -------
    tuple of torch.Tensor
        ``y (B, T, D)`` in x's dtype and ``h_T (B, D, N)`` float32.
    """
    _build.refuse_grad("ssm_scan", x, dt, A, Bm, Cm, D, h0)
    tensors = (x, dt, A, Bm, Cm, D) + (() if h0 is None else (h0,))
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"ssm_scan kernel takes CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if x.dtype not in _SUFFIX or any(t.dtype != x.dtype for t in (dt, Bm, Cm, D)):
        raise ValueError(f"ssm_scan kernel takes f32/bf16 x, dt, B, C and D of one "
                         f"dtype, got {[t.dtype for t in (x, dt, Bm, Cm, D)]}")
    if A.dtype != torch.float32 or (h0 is not None and h0.dtype != torch.float32):
        raise ValueError(f"ssm_scan kernel takes float32 A and h0, got {A.dtype} and "
                         f"{None if h0 is None else h0.dtype}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"ssm_scan kernel takes x (B, T, D) and A (D, N), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    B, T, Dd = x.shape
    N = A.shape[1]
    if (dt.shape != x.shape or A.shape != (Dd, N) or Bm.shape != (B, T, N)
            or Cm.shape != (B, T, N) or D.shape != (Dd,)
            or (h0 is not None and h0.shape != (B, Dd, N))):
        raise ValueError(
            f"ssm_scan kernel: shapes do not agree: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(Bm.shape)}, C "
            f"{tuple(Cm.shape)}, D {tuple(D.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)}")
    if not 1 <= N <= MAX_STATE or T < 1 or B > MAX_BATCH:
        raise ValueError(f"ssm_scan kernel takes 1 <= N <= {MAX_STATE}, T >= 1 and "
                         f"B <= {MAX_BATCH}, got N={N}, T={T}, B={B}")
    A, D = A.contiguous(), D.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((B, T, Dd), dtype=x.dtype, device=x.device)
    hT = torch.empty((B, Dd, N), dtype=torch.float32, device=x.device)
    name = f"ssm_scan_{_SUFFIX[x.dtype]}"
    code = _build.entry(name)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        hT.data_ptr(), B, T, Dd, N, _build.ssm_scan_lanes(N), *x.stride(), *dt.stride(),
        *Bm.stride(), *Cm.stride(), _build.current_stream(x.device),
    )
    _build.check(code, name)
    ssm_scan.launches += 1
    return y, hT


ssm_scan.launches = 0
