"""CUDA kernels for the PowerSGD hot loop: P = M Q and Q = Mᵀ P̂ over every
gradient bucket slab, every step (source: ``csrc/lowrank.cu``).

They replace the Pallas kernels of ``repro.kernels.lowrank`` (project:
``_project_kernel``/``_project_kernel_batched``; backproject:
``_backproject_kernel``/``_backproject_kernel_batched``).  Inputs of any
rank ≥ 2 fold their leading dims into the kernels' batch grid dimension, so
one launch covers a whole bucket — for every simulated worker at once.

The wrappers take CUDA float32 tensors only and raise on anything else; the
CPU path is :mod:`repro_torch.kernels.ops`' job.  The library builds with
``nvcc`` on first use (:mod:`repro_torch.kernels._build`).  ``LAUNCHES``
counts the wrapper calls that launched their kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

MAX_RANK = 32
LAUNCHES = {"lowrank_project": 0, "lowrank_backproject": 0}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library() -> ctypes.CDLL:
    """The built kernel library (built and loaded on first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("lowrank")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.lowrank_project, lib.lowrank_backproject):
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
            fn.restype = i32
        for fn in (lib.lowrank_project_splits, lib.lowrank_backproject_splits):
            fn.argtypes = [i32, i32, i32, i32, i32]
            fn.restype = i32
        lib.lowrank_error_string.argtypes = [i32]
        lib.lowrank_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(m: torch.Tensor, f: torch.Tensor, f_rows: int, what: str):
    """Validate (M, factor) for a launch; returns (B, n, m, r)."""
    for name, t in (("M", m), (what, f)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if m.device != f.device:
        raise ValueError(f"M on {m.device} but {what} on {f.device}")
    if m.ndim < 2:
        raise ValueError(f"M must have ≥2 dims, got shape {tuple(m.shape)}")
    n, k = m.shape[-2:]
    r = f.shape[-1]
    want = tuple(m.shape[:-2]) + ((n, k)[f_rows], r)
    if tuple(f.shape) != want:
        raise ValueError(f"{what} shape {tuple(f.shape)} does not match M "
                         f"{tuple(m.shape)}: want {want}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside 1..{MAX_RANK}")
    b = math.prod(m.shape[:-2])
    if min(b, n, k) < 1:
        raise ValueError(f"empty M {tuple(m.shape)}")
    if max(b, n, k) >= 2**31 or b > 65535:
        raise ValueError(f"M {tuple(m.shape)} exceeds the kernel's index range")
    return b, n, k, r


def _launch(name: str, m: torch.Tensor, f: torch.Tensor, what: str,
            f_rows: int, out_rows: int):
    b, n, k, r = _check(m, f, f_rows, what)
    lib = library()
    rows = (n, k)[out_rows]
    out = torch.empty(m.shape[:-2] + (rows, r), device=m.device,
                      dtype=torch.float32)
    sms = torch.cuda.get_device_properties(m.device).multi_processor_count
    splits = getattr(lib, f"{name}_splits")(b, n, k, r, sms)
    scratch = (torch.empty(splits * b * rows * r, device=m.device,
                           dtype=torch.float32) if splits > 1 else None)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        err = getattr(lib, name)(
            m.data_ptr(), f.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, n, k, r, splits, sms, stream)
    if err:
        msg = lib.lowrank_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES[name] += 1
    return out


def lowrank_project(m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = M Q.  m: (..., n, k), q: (..., k, r) → (..., n, r), r ≤ 32."""
    return _launch("lowrank_project", m, q, "Q", f_rows=1, out_rows=0)


def lowrank_backproject(m: torch.Tensor, p_hat: torch.Tensor) -> torch.Tensor:
    """Q = Mᵀ P̂.  m: (..., n, k), p_hat: (..., n, r) → (..., k, r), r ≤ 32."""
    return _launch("lowrank_backproject", m, p_hat, "P", f_rows=0, out_rows=1)
