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

For training, ``return_states`` also returns the state before every
:data:`~repro_torch.kernels._build.SSM_CKPT_STEPS` steps, and
:func:`ssm_scan_bwd` wraps the backward kernel (``csrc/ssm_scan_bwd.cu``):
every gradient (x, dt, A, B, C, D and h0) from those checkpoints and the
gradients of y and h_T, deterministic (partials summed in a fixed order by
a second launch), with the forward's lane forms and strided inputs; what
the form launched takes on the card (registers, shared memory, CTAs a SM)
is :func:`repro_torch.kernels._build.ssm_scan_bwd_form`.  Its
calls are counted in ``ssm_scan_bwd.launches``; its plain version is
:func:`repro_torch.kernels.ref.ssm_scan_bwd_ref`.  The trainer reaches
both through ``ops._SSMScan``; called directly with grad mode on and an
input that requires grad, the forward wrapper raises (its output has no
gradient).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: largest state size N the kernel keeps in registers (Jamba: 16)
MAX_STATE = _build.SSM_MAX_STATE
#: most sequences one launch takes (the grid's second axis)
MAX_BATCH = 65535


def _check_inputs(name, x, dt, A, Bm, Cm, D, h0):
    """What both kernels take: CUDA tensors on one device, x, dt, B, C and
    D of one f32/bf16 dtype, float32 A and h0, agreeing shapes; returns
    ``(B, T, D, N)``."""
    tensors = (x, dt, A, Bm, Cm, D) + (() if h0 is None else (h0,))
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{name} kernel takes CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if x.dtype not in _SUFFIX or any(t.dtype != x.dtype for t in (dt, Bm, Cm, D)):
        raise ValueError(f"{name} kernel takes f32/bf16 x, dt, B, C and D of one "
                         f"dtype, got {[t.dtype for t in (x, dt, Bm, Cm, D)]}")
    if A.dtype != torch.float32 or (h0 is not None and h0.dtype != torch.float32):
        raise ValueError(f"{name} kernel takes float32 A and h0, got {A.dtype} and "
                         f"{None if h0 is None else h0.dtype}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"{name} kernel takes x (B, T, D) and A (D, N), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    B, T, Dd = x.shape
    N = A.shape[1]
    if (dt.shape != x.shape or A.shape != (Dd, N) or Bm.shape != (B, T, N)
            or Cm.shape != (B, T, N) or D.shape != (Dd,)
            or (h0 is not None and h0.shape != (B, Dd, N))):
        raise ValueError(
            f"{name} kernel: shapes do not agree: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(Bm.shape)}, C "
            f"{tuple(Cm.shape)}, D {tuple(D.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)}")
    if not 1 <= N <= MAX_STATE or T < 1 or B > MAX_BATCH:
        raise ValueError(f"{name} kernel takes 1 <= N <= {MAX_STATE}, T >= 1 and "
                         f"B <= {MAX_BATCH}, got N={N}, T={T}, B={B}")
    return B, T, Dd, N


def ssm_scan(
    x: torch.Tensor,       # (B, T, D)
    dt: torch.Tensor,      # (B, T, D)
    A: torch.Tensor,       # (D, N) float32
    Bm: torch.Tensor,      # (B, T, N)
    Cm: torch.Tensor,      # (B, T, N)
    D: torch.Tensor,       # (D,)
    h0: Optional[torch.Tensor] = None,   # (B, D, N) float32
    return_states: bool = False,
):
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
    return_states : bool
        Also return the checkpoints :func:`ssm_scan_bwd` reads.

    Returns
    -------
    tuple of torch.Tensor
        ``y (B, T, D)`` in x's dtype and ``h_T (B, D, N)`` float32; with
        ``return_states`` also ``states (B, ceil(T / SSM_CKPT_STEPS), D, N)``
        float32, the state before steps 0, ``SSM_CKPT_STEPS``, ...
    """
    _build.refuse_grad("ssm_scan", x, dt, A, Bm, Cm, D, h0)
    B, T, Dd, N = _check_inputs("ssm_scan", x, dt, A, Bm, Cm, D, h0)
    A, D = A.contiguous(), D.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((B, T, Dd), dtype=x.dtype, device=x.device)
    hT = torch.empty((B, Dd, N), dtype=torch.float32, device=x.device)
    states = (torch.empty((B, _build.ssm_checkpoints(T), Dd, N), dtype=torch.float32,
                          device=x.device) if return_states else None)
    name = f"ssm_scan_{_SUFFIX[x.dtype]}"
    code = _build.entry(name)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        hT.data_ptr(), None if states is None else states.data_ptr(), B, T, Dd, N,
        _build.ssm_scan_lanes(N), *x.stride(), *dt.stride(), *Bm.stride(), *Cm.stride(),
        _build.current_stream(x.device),
    )
    _build.check(code, name)
    ssm_scan.launches += 1
    return (y, hT, states) if return_states else (y, hT)


ssm_scan.launches = 0


def ssm_scan_bwd(
    x: torch.Tensor,       # (B, T, D)
    dt: torch.Tensor,      # (B, T, D)
    A: torch.Tensor,       # (D, N) float32
    Bm: torch.Tensor,      # (B, T, N)
    Cm: torch.Tensor,      # (B, T, N)
    D: torch.Tensor,       # (D,)
    states: torch.Tensor,  # (B, ceil(T / SSM_CKPT_STEPS), D, N) float32
    dy: torch.Tensor,      # (B, T, D) gradient of y
    h0: Optional[torch.Tensor] = None,    # (B, D, N) float32
    dhT: Optional[torch.Tensor] = None,   # (B, D, N) float32 gradient of h_T
):
    """Gradients of :func:`ssm_scan`; the semantics of ``ref.ssm_scan_bwd_ref``.

    ``states`` is the forward's ``return_states`` output on the same
    inputs.  x, dt, B and C are read through their strides; ``dhT=None``
    means h_T's gradient is zero.

    Returns
    -------
    tuple
        ``(dx, ddt, dA, dB, dC, dD, dh0)``: dx, ddt ``(B, T, D)`` in x's
        dtype, dA ``(D, N)`` float32, dB and dC ``(B, T, N)`` contiguous in
        B's dtype, dD ``(D,)`` in D's, and dh0 ``(B, D, N)`` float32 when h0
        was given, else None.
    """
    B, T, Dd, N = _check_inputs("ssm_scan_bwd", x, dt, A, Bm, Cm, D, h0)
    nc = _build.ssm_checkpoints(T)
    if (not states.is_cuda or states.device != x.device or states.dtype != torch.float32
            or states.shape != (B, nc, Dd, N) or not states.is_contiguous()):
        raise ValueError(f"ssm_scan_bwd kernel takes contiguous float32 states "
                         f"({B}, {nc}, {Dd}, {N}) on {x.device}, got {states.dtype} "
                         f"{tuple(states.shape)} on {states.device}")
    if dy.device != x.device or dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"ssm_scan_bwd kernel takes dy shaped and typed as x, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if dhT is not None and (dhT.device != x.device or dhT.dtype != torch.float32
                            or dhT.shape != (B, Dd, N)):
        raise ValueError(f"ssm_scan_bwd kernel takes a float32 dhT ({B}, {Dd}, {N}) on "
                         f"{x.device}, got {dhT.dtype} {tuple(dhT.shape)} on {dhT.device}")
    A, D, dy = A.contiguous(), D.contiguous(), dy.contiguous()
    dhT = None if dhT is None else dhT.contiguous()
    dev, f32 = x.device, torch.float32
    n_blk = -(-Dd // _build.SSM_CHANNELS_PER_CTA)
    dx = torch.empty((B, T, Dd), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, T, Dd), dtype=x.dtype, device=dev)
    part_bc = torch.empty((2, n_blk, B, T, N), dtype=f32, device=dev)
    part_a = torch.empty((B, Dd, N), dtype=f32, device=dev)
    part_d = torch.empty((B, Dd), dtype=f32, device=dev)
    dB = torch.empty((B, T, N), dtype=x.dtype, device=dev)
    dC = torch.empty((B, T, N), dtype=x.dtype, device=dev)
    dA = torch.empty((Dd, N), dtype=f32, device=dev)
    dD = torch.empty((Dd,), dtype=x.dtype, device=dev)
    dh0 = None if h0 is None else torch.empty((B, Dd, N), dtype=f32, device=dev)
    name = f"ssm_scan_bwd_{_SUFFIX[x.dtype]}"
    code = _build.entry(name)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        states.data_ptr(), dy.data_ptr(), None if dhT is None else dhT.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), part_bc.data_ptr(), part_a.data_ptr(),
        part_d.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), dD.data_ptr(),
        None if dh0 is None else dh0.data_ptr(), B, T, Dd, N, _build.ssm_scan_lanes(N),
        *x.stride(), *dt.stride(), *Bm.stride(), *Cm.stride(), _build.current_stream(dev),
    )
    _build.check(code, name)
    ssm_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dD, dh0


ssm_scan_bwd.launches = 0
