"""CUDA kernels for the int4 wire format: nibble pack and unpack of the
quantized gather's payload (source: ``csrc/quant.cu``).

They replace the Pallas kernels of ``repro.kernels.quant``
(``_pack_kernel`` behind ``nibble_pack``, ``_unpack_kernel`` behind
``nibble_unpack``).  Leading dims fold into rows, so one launch packs or
unpacks every simulated worker's payload; the result is bit-for-bit that of
:func:`repro_torch.kernels.ref.nibble_pack` / ``nibble_unpack``.

The wrappers take CUDA tensors only and raise on anything else; the CPU
path is :mod:`repro_torch.kernels.ops`' job.  The library builds with
``nvcc`` on first use (:mod:`repro_torch.kernels._build`).  Each kernel
launches as a programmatic dependent of the kernel before it on the stream
(Hopper's PDL; ``csrc/quant.cu`` says why); a refused launch raises with its
CUDA error.  ``LAUNCHES`` counts the wrapper calls that launched their
kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

LAUNCHES = {"nibble_pack": 0, "nibble_unpack": 0}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library() -> ctypes.CDLL:
    """The built kernel library (built and loaded on first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("quant")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.nibble_pack.argtypes = [ptr, ptr, i64, i64, ptr]
        lib.nibble_unpack.argtypes = [ptr, ptr, i64, i64, i64, ptr]
        lib.nibble_pack.restype = lib.nibble_unpack.restype = i32
        lib.quant_error_string.argtypes = [i32]
        lib.quant_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, dtype: torch.dtype, what: str) -> int:
    """Validate one input; returns its number of rows."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"{what} must be non-empty with ≥1 dim, got shape "
                         f"{tuple(x.shape)}")
    return math.prod(x.shape[:-1])


def _launch(name: str, x: torch.Tensor, out: torch.Tensor, *sizes: int):
    lib = library()
    with torch.cuda.device(x.device.index):
        err = getattr(lib, name)(x.data_ptr(), out.data_ptr(), *sizes,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.quant_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES[name] += 1
    return out


def nibble_pack(q: torch.Tensor) -> torch.Tensor:
    """(..., n) int8 codes → (..., ceil(n/2)) uint8, two codes per byte."""
    rows = _check(q, torch.int8, "codes")
    n = q.shape[-1]
    out = torch.empty(q.shape[:-1] + ((n + 1) // 2,), device=q.device,
                      dtype=torch.uint8)
    return _launch("nibble_pack", q, out, rows, n)


def nibble_unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(..., nb) uint8 → (..., n) int8 codes in [-8, 7]; 1 ≤ n ≤ 2·nb."""
    rows = _check(packed, torch.uint8, "packed")
    nb = packed.shape[-1]
    if not 1 <= n <= 2 * nb:
        raise ValueError(f"n = {n} codes do not fit {nb} packed bytes")
    out = torch.empty(packed.shape[:-1] + (n,), device=packed.device,
                      dtype=torch.int8)
    return _launch("nibble_unpack", packed, out, rows, nb, n)
