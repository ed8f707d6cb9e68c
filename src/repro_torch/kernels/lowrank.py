"""CUDA kernels for the PowerSGD hot loop: P = M Q and Q = Mᵀ P̂ over every
gradient bucket slab, every step (source: ``csrc/lowrank.cu``).

They replace the Pallas kernels of ``repro.kernels.lowrank`` (project:
``_project_kernel``/``_project_kernel_batched``; backproject:
``_backproject_kernel``/``_backproject_kernel_batched``).  Inputs of any
rank ≥ 2 fold their leading dims into one batch dim, so one launch covers a
whole bucket, for every simulated worker at once.

Each call is one launch of one kernel.  Its layout comes from
:func:`plan_project` / :func:`plan_backproject`, pure functions of the
shape, the rank, the card's SM count and whether M is 16-byte aligned: a
1-D grid of ``tiles`` thread-block clusters of ``cluster`` CTAs each, the
CTAs of a cluster splitting the reduced dimension into runs of ``extent``
and adding their partial sums through distributed shared memory in rank
order.  There is no scratch buffer and no second pass, and two calls on
the same inputs give the same bits.

The wrappers take CUDA float32 tensors only and raise on anything else;
the CPU path is :mod:`repro_torch.kernels.ops`' job.  The library builds
with ``nvcc`` on first use (:mod:`repro_torch.kernels._build`).
``LAUNCHES`` counts the wrapper calls that launched their kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.kernels import _build

MAX_RANK = 32
LAUNCHES = {"lowrank_project": 0, "lowrank_backproject": 0}

NUM_WARPS = 8           # warps per CTA (256 threads)
STEP = 128              # project: columns a warp reads per step, 32 lanes × 4
CLUSTER_MAX = 8         # CTAs per cluster: the portable limit
WAVES = 4               # CTAs per SM at most in the plans' one wave
CTA_BYTES = 16 * 1024   # bytes of M per CTA the plans aim for, at least
SPLIT_BYTES = 64 * 1024 # backproject: bytes of M a CTA reads before its rows split
NARROW_WORDS_BYTES = 64 * 2**20  # backproject: largest slab read in words whose
                                 # strips narrow below 32 lanes
WINDOW_FLOATS = 4096    # project: floats of Q staged per shared-memory buffer

_LIB = None
_SMS: dict[int, int] = {}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call covers its (B, n, m) slab.

    ``tiles`` clusters of ``cluster`` CTAs; a cluster owns ``tile`` of the
    kept dimension (project: rows of M per CTA, each read by
    ``col_warps`` warps that share its steps; backproject: a strip of
    ``lanes`` × ``lane_cols`` columns, ``lanes`` lanes to a row) and its
    CTAs split the reduced dimension (project: m; backproject: n) into runs
    of ``extent``, rank k taking [k·extent, (k+1)·extent).  ``vec`` 4 reads
    M in 16-byte loads, 1 in 4-byte words.  ``window``: project stages Q
    this many columns at a time (0 for backproject)."""

    vec: int
    tile: int
    tiles: int
    cluster: int
    extent: int
    window: int = 0
    col_warps: int = 1
    lanes: int = 32

    @property
    def ctas(self) -> int:
        return self.tiles * self.cluster


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rank_pad(r: int) -> int:
    """The kernels' accumulator width: r rounded up to a power of two."""
    return 1 << (r - 1).bit_length()


def _split(length: int, want: int, quantum: int = 1) -> tuple[int, int]:
    """(ranks, extent): ``length`` cut into at most ``want`` runs of one
    extent, a multiple of ``quantum``, none of them empty."""
    extent = _cdiv(_cdiv(length, max(1, want)), quantum) * quantum
    return _cdiv(length, extent), extent


def lane_cols(rp: int) -> int:
    """Backproject: columns of a strip one lane owns at accumulator width rp."""
    return 4 if rp <= 8 else 32 // rp


def _target(b: int, n: int, m: int, sms: int) -> int:
    """CTAs to aim for: one per ``CTA_BYTES`` of M, at least one per SM and
    at most one wave of ``WAVES`` per SM."""
    return max(sms, min(WAVES * sms, 4 * b * n * m // CTA_BYTES))


def load_slots(rp: int) -> int:
    """Project: loads of M a lane has in flight at accumulator width rp."""
    return 4 if rp <= 8 else 2 if rp == 16 else 1


def plan_project(b: int, n: int, m: int, r: int, sms: int,
                 aligned: bool = True) -> LaunchPlan:
    """Launch plan of P = M Q for M (b, n, m), rank r, on ``sms`` SMs.

    Until the grid reaches the target, without passing one wave: fewer rows
    per CTA, down to one per warp; then 2, 4 or 8 warps to a row, each
    taking every 2nd, 4th or 8th 128-column step.  Only a grid still under
    half the target splits the columns over a cluster."""
    rp = rank_pad(r)
    target = _target(b, n, m, sms)
    steps = _cdiv(m, STEP)

    def tiles(t):
        return b * _cdiv(n, t)

    tile, wc = NUM_WARPS * load_slots(rp), 1
    while tiles(tile) < target:
        nxt = (tile // 2, wc) if tile > NUM_WARPS else (tile // 2, wc * 2)
        if nxt[0] < 1 or nxt[1] > steps or tiles(nxt[0]) > WAVES * sms:
            break
        tile, wc = nxt
    want = 1
    if 2 * tiles(tile) < target:
        want = max(1, min(CLUSTER_MAX, target // tiles(tile), steps // wc))
    cluster, extent = _split(m, want, quantum=4)
    return LaunchPlan(vec=4 if aligned and m % 4 == 0 else 1, tile=tile,
                      tiles=tiles(tile), cluster=cluster, extent=extent,
                      window=min(extent, WINDOW_FLOATS // rp), col_warps=wc)


def cluster_room(cluster: int, sms: int) -> int:
    """CTAs of one wave in clusters of ``cluster``: ``WAVES`` per SM for
    clusters of 1 or 2; 7/8 of that for larger ones, which the card packs
    less tightly (``cudaOccupancyMaxActiveClusters`` on an H100 gives
    these kernels fewer CTAs in clusters of 3 to 8 than in a plain grid,
    but more than 7/8 of it)."""
    return WAVES * sms if cluster <= 2 else WAVES * sms * 7 // 8


def plan_backproject(b: int, n: int, m: int, r: int, sms: int,
                     aligned: bool = True) -> LaunchPlan:
    """Launch plan of Q = Mᵀ P̂ for M (b, n, m), rank r, on ``sms`` SMs.

    Strips of ``lanes`` × ``lane_cols`` columns, read in 16-byte loads where
    rows are aligned and r ≤ 8, else in words: 32 lanes to a row, halved
    (to 8 at least) while the grid is short of the target; in words only on
    a slab of at most ``NARROW_WORDS_BYTES``, since a row's part narrower
    than 32 words wastes sectors.  A CTA that would still read more than
    ``SPLIT_BYTES`` splits its rows over a cluster, down to ``CTA_BYTES`` a
    CTA, within the target and one wave, at least one row per warp a
    rank."""
    rp = rank_pad(r)
    vec = 4 if rp <= 8 and aligned and m % 4 == 0 else 1
    target = _target(b, n, m, sms)
    lanes = 32
    while (lanes > 8 and b * _cdiv(m, lanes * lane_cols(rp)) < target
           and (vec == 4 or 4 * b * n * m <= NARROW_WORDS_BYTES)):
        lanes //= 2
    tiles = b * _cdiv(m, lanes * lane_cols(rp))
    per_tile = 4 * n * m // _cdiv(m, lanes * lane_cols(rp))
    want = 1
    if per_tile > SPLIT_BYTES:
        while (want < min(CLUSTER_MAX, _cdiv(n, NUM_WARPS)) and tiles * want < target
               and per_tile // want > CTA_BYTES
               and tiles * (want + 1) <= cluster_room(want + 1, sms)):
            want += 1
    cluster, extent = _split(n, want)
    return LaunchPlan(vec=vec, tile=lanes * lane_cols(rp), tiles=tiles,
                      cluster=cluster, extent=extent, lanes=lanes)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library() -> ctypes.CDLL:
    """The built kernel library (built and loaded on first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("lowrank")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lowrank_project.argtypes = [ptr, ptr, ptr] + [i32] * 10 + [ptr]
        lib.lowrank_backproject.argtypes = [ptr, ptr, ptr] + [i32] * 8 + [ptr]
        for fn in (lib.lowrank_project, lib.lowrank_backproject):
            fn.restype = i32
        lib.lowrank_error_string.argtypes = [i32]
        lib.lowrank_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def sm_count(device: torch.device) -> int:
    """Number of SMs of a CUDA device, read once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


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
    if max(b, n, k) >= 2**31:
        raise ValueError(f"M {tuple(m.shape)} exceeds the kernel's index range")
    return b, n, k, r


def _launch(name: str, m: torch.Tensor, f: torch.Tensor, what: str,
            f_rows: int, out_rows: int):
    b, n, k, r = _check(m, f, f_rows, what)
    project = name == "lowrank_project"
    planner = plan_project if project else plan_backproject
    plan = planner(b, n, k, r, sm_count(m.device), aligned=m.data_ptr() % 16 == 0)
    if plan.ctas >= 2**31:
        raise ValueError(f"M {tuple(m.shape)} exceeds the kernel's index range "
                         f"({plan.ctas} CTAs)")
    lib = library()
    out = torch.empty(m.shape[:-2] + ((n, k)[out_rows], r), device=m.device,
                      dtype=torch.float32)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        args = (m.data_ptr(), f.data_ptr(), out.data_ptr(), b, n, k, r, plan.vec)
        if project:
            err = lib.lowrank_project(*args, plan.tile, plan.col_warps, plan.cluster,
                                      plan.extent, plan.window, stream)
        else:
            err = lib.lowrank_backproject(*args, plan.lanes, plan.cluster, plan.extent,
                                          stream)
    if err:
        msg = lib.lowrank_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} "
                           f"({msg}) under {plan}")
    LAUNCHES[name] += 1
    return out


def lowrank_project(m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = M Q.  m: (..., n, k), q: (..., k, r) → (..., n, r), r ≤ 32."""
    return _launch("lowrank_project", m, q, "Q", f_rows=1, out_rows=0)


def lowrank_backproject(m: torch.Tensor, p_hat: torch.Tensor) -> torch.Tensor:
    """Q = Mᵀ P̂.  m: (..., n, k), p_hat: (..., n, r) → (..., k, r), r ≤ 32."""
    return _launch("lowrank_backproject", m, p_hat, "P", f_rows=0, out_rows=1)
