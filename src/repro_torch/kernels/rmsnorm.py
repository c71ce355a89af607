"""Fused RMSNorm: the wrapper of the hand-written CUDA kernel.

Replaces the JAX package's Pallas kernel (``repro/kernels/rmsnorm.py``);
the kernel is ``csrc/rmsnorm.cu``.  The wrapper takes CUDA tensors only
(the plain version, :func:`repro_torch.kernels.ref.rmsnorm_ref`, serves
the CPU through :mod:`repro_torch.kernels.ops`), checks what the kernel
accepts, allocates the output, takes the warps a row from
:func:`repro_torch.kernels._build.rmsnorm_warps` and counts its launches
in ``rmsnorm.launches`` (a call with no rows launches nothing).  Called
with grad mode on and an input that requires grad it raises: its output
has no gradient (the trainer's route is ``ops._RMSNorm``).

:func:`rmsnorm_bwd` wraps the backward kernel (``csrc/rmsnorm_bwd.cu``:
one pass over x and dy held in registers, dx a row, dgamma through
per-CTA f32 partials and a second reduction launch, deterministic; the
slots a thread holds from
:func:`repro_torch.kernels._build.rmsnorm_bwd_slots`, the form from
:func:`rmsnorm_bwd_aligned`, the rows a CTA from the form's occupancy),
counted in ``rmsnorm_bwd.launches``.
"""

from __future__ import annotations

import torch

from . import _build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x**2, -1) + eps) * gamma`` in f32, cast to ``x.dtype``.

    Parameters
    ----------
    x : torch.Tensor
        ``(..., d)`` CUDA tensor, float32 or bfloat16, contiguous.
    gamma : torch.Tensor
        ``(d,)`` scale of the same dtype and device.
    eps : float, optional
        Added to the mean square before the root.

    Returns
    -------
    torch.Tensor
        Same shape and dtype as ``x``.
    """
    _build.refuse_grad("rmsnorm", x, gamma)
    if not x.is_cuda or gamma.device != x.device:
        raise ValueError(
            f"rmsnorm kernel takes CUDA tensors on one device, got "
            f"{x.device} and {gamma.device}"
        )
    if x.dtype not in _SUFFIX or gamma.dtype != x.dtype:
        raise ValueError(f"rmsnorm kernel takes f32/bf16 x and gamma of one "
                         f"dtype, got {x.dtype} and {gamma.dtype}")
    d = x.shape[-1]
    if gamma.shape != (d,) or not x.is_contiguous() or not gamma.is_contiguous():
        raise ValueError(f"rmsnorm kernel takes contiguous x (..., {d}) and "
                         f"gamma ({d},), got {tuple(x.shape)} and "
                         f"{tuple(gamma.shape)}")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out     # nothing to launch
    name = f"rmsnorm_{_SUFFIX[x.dtype]}"
    code = _build.entry(name)(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows, d,
        _build.rmsnorm_warps(d, x.dtype), float(eps), _build.current_stream(x.device),
    )
    _build.check(code, name)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5):
    """Gradients ``(dx, dgamma)`` of :func:`rmsnorm`; the semantics of
    ``ref.rmsnorm_bwd_ref``.

    Parameters
    ----------
    x, dy : torch.Tensor
        ``(..., d)`` contiguous CUDA tensors of one dtype, float32 or
        bfloat16, ``d <= RMSNORM_BWD_MAX_D``.
    gamma : torch.Tensor
        ``(d,)`` scale of the same dtype and device.

    Returns
    -------
    tuple of torch.Tensor
        ``dx`` shaped as x and ``dgamma`` ``(d,)``, in x's dtype.
    """
    if not (x.is_cuda and gamma.device == x.device and dy.device == x.device):
        raise ValueError("rmsnorm backward kernel takes CUDA tensors on one device")
    if x.dtype not in _SUFFIX or gamma.dtype != x.dtype or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm backward kernel takes f32/bf16 x, gamma and dy of one "
                         f"dtype, got {x.dtype}, {gamma.dtype}, {dy.dtype}")
    d = x.shape[-1]
    if (gamma.shape != (d,) or dy.shape != x.shape or not x.is_contiguous()
            or not dy.is_contiguous() or not gamma.is_contiguous()
            or not 1 <= d <= _build.RMSNORM_BWD_MAX_D):
        raise ValueError(f"rmsnorm backward kernel takes contiguous x and dy (..., d) and "
                         f"gamma (d,), 1 <= d <= {_build.RMSNORM_BWD_MAX_D}; got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}, {tuple(gamma.shape)}")
    dx = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return dx, torch.zeros_like(gamma)    # nothing to launch
    slots = _build.rmsnorm_bwd_slots(d, x.dtype)
    aligned = rmsnorm_bwd_aligned(d, x.element_size(), x.data_ptr(), gamma.data_ptr(),
                                  dy.data_ptr(), dx.data_ptr())
    index = x.device.index
    per_sm = _build.rmsnorm_bwd_ctas_per_sm(x.dtype, d, slots, aligned, index)
    run = _build.rmsnorm_bwd_rows(rows, _build.sm_count(index), per_sm)
    partial = torch.empty((-(-rows // run), d), dtype=torch.float32, device=x.device)
    dgamma = torch.empty_like(gamma)
    name = f"rmsnorm_bwd_{_SUFFIX[x.dtype]}"
    code = _build.entry(name)(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dgamma.data_ptr(), rows, d, run, slots, int(aligned), float(eps),
        _build.current_stream(x.device),
    )
    _build.check(code, name)
    rmsnorm_bwd.launches += 1
    return dx, dgamma


rmsnorm_bwd.launches = 0


def rmsnorm_bwd_aligned(d: int, itemsize: int, *ptrs: int) -> bool:
    """Whether the RMSNorm backward kernel takes its aligned form (every
    access one plain 16-byte vector): each of the contiguous tensors' data
    pointers ``ptrs`` starts on 16 bytes and a row of ``d`` values of
    ``itemsize`` bytes is a whole number of 16-byte vectors.  The launcher
    refuses the aligned form where this does not hold."""
    return d % (16 // itemsize) == 0 and not any(p % 16 for p in ptrs)
