"""CUDA kernel for the fused error-feedback apply: Δ' = P̂ Qᵀ rebuilt tile
by tile, then the momentum and parameter updates, in one pass over x and
the momentum (source: ``csrc/ef_apply.cu``).

It replaces the Pallas kernel of ``repro.kernels.ef_apply``
(``_ef_apply_kernel`` behind ``_ef_apply_2d`` and ``ef_apply``).  Leading
dims fold into the kernel's batch grid dimension, so one launch covers a
whole ``(B, n, m)`` slab; any rank r ≥ 1.

The wrapper takes CUDA float32 tensors only and raises on anything else,
non-contiguous inputs included (it copies nothing); the CPU path is
:mod:`repro_torch.kernels.ops`' job.  The library builds with ``nvcc`` on
first use (:mod:`repro_torch.kernels._build`).  ``LAUNCHES`` counts the
wrapper calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

LAUNCHES = {"ef_apply": 0}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library() -> ctypes.CDLL:
    """The built kernel library (built and loaded on first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("ef_apply")
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_float)
        lib.ef_apply.argtypes = [ptr] * 6 + [i64, i64, i64, i32, f32, f32, ptr]
        lib.ef_apply.restype = i32
        lib.ef_apply_error_string.argtypes = [i32]
        lib.ef_apply_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(x, mom, p_hat, q):
    """Validate the inputs of one launch; returns (B, n, m, r)."""
    named = (("x", x), ("mom", mom), ("p_hat", p_hat), ("q", q))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} (the "
                            f"kernels take float32 only: ROADMAP queue B)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the wrapper does "
                             f"not copy)")
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
    if x.ndim < 2 or tuple(mom.shape) != tuple(x.shape):
        raise ValueError(f"x {tuple(x.shape)} and mom {tuple(mom.shape)} must "
                         f"share one shape of ≥2 dims")
    lead, (n, m) = tuple(x.shape[:-2]), x.shape[-2:]
    r = q.shape[-1] if q.ndim else 0
    if tuple(p_hat.shape) != lead + (n, r) or tuple(q.shape) != lead + (m, r):
        raise ValueError(f"p_hat {tuple(p_hat.shape)} and q {tuple(q.shape)} do "
                         f"not match x {tuple(x.shape)}: want {lead + (n, r)} "
                         f"and {lead + (m, r)}")
    b = math.prod(lead)
    if min(b, n, m, r) < 1:
        raise ValueError(f"empty input: x {tuple(x.shape)}, rank {r}")
    if b > 65535 or r >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} at rank {r} exceeds the "
                         f"kernel's grid")
    return b, n, m, r


def ef_apply(x: torch.Tensor, mom: torch.Tensor, p_hat: torch.Tensor,
             q: torch.Tensor, lr: float, lam: float):
    """``mom' = lam·mom + P̂ Qᵀ``, ``x' = x − lr·(P̂ Qᵀ + mom')``.

    x, mom: (..., n, m); p_hat: (..., n, r); q: (..., m, r).  Returns
    (x', mom'), new tensors."""
    b, n, m, r = _check(x, mom, p_hat, q)
    lib = library()
    x_out, mom_out = torch.empty_like(x), torch.empty_like(mom)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ef_apply(x.data_ptr(), mom.data_ptr(), p_hat.data_ptr(),
                           q.data_ptr(), x_out.data_ptr(), mom_out.data_ptr(),
                           b, n, m, r, float(lr), float(lam), stream)
    if err:
        msg = lib.ef_apply_error_string(err).decode()
        raise RuntimeError(f"ef_apply: kernel launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["ef_apply"] += 1
    return x_out, mom_out
