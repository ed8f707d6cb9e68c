"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) layer, the training
half (port of ``init``, ``pspecs``, ``mspecs``, ``_sharded_gated_rmsnorm``,
``_causal_depthwise_conv``, ``forward`` and ``_ssd_scan`` of
``repro.models.mamba2``).

Chunked SSD: within a chunk the recurrence is materialised as a masked,
decay-weighted attention-like matrix; across chunks a loop carries the
(N × P) state per head.  The recurrent decode waits for ROADMAP queue A,
item 15 (its decode half); :func:`_ssd_scan` already returns the final
state a prefill hands to it.

Tensor parallelism: d_inner (the heads) is column-split over the ``model``
axis; the B/C projections (one group) are replicated; ``out_proj`` is
row-parallel.  The gated RMSNorm before ``out_proj`` normalises over the
*global* d_inner through a ``psum_model`` of the local sum of squares.
The per-head vectors (``A_log``, ``D``, ``dt_bias``), the norm scale and
the depthwise filter are split over the model axis and, by the paper's
bias rule, aggregated uncompressed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import SINGLE, MeshCtx
from repro_torch.core.matrixize import NONE as SPEC_NONE, MatrixSpec
from repro_torch.models import common
from repro_torch.sharding import P


# the Cephes polynomial of XLA's float32 log on the CPU (Eigen's plog)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _fma(a, b, c):
    """``a·b + c`` of float32 values with one rounding (float64 inside)."""
    f = lambda t: torch.as_tensor(t, dtype=torch.float32).double()
    return (f(a) * f(b) + f(c)).float()


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` of positive normal ``x`` as XLA computes it on the
    CPU: the exponent split off, the mantissa folded into [√½, √2) and
    Cephes' degree-8 polynomial with fused multiply-adds."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < 0.707106781186547524
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(_fma(p[0], m, p[1]), m, p[2])
    y1 = _fma(_fma(p[3], m, p[4]), m, p[5])
    y2 = _fma(_fma(p[6], m, p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2) * x3
    y = _fma(e, _LOG_Q1, y)
    r = _fma(x2, -0.5, m) + y
    return _fma(e, _LOG_Q2, r)


def _a_log(h: int) -> torch.Tensor:
    """``log(linspace(1, 16, h))`` in float32, with the bits of the JAX
    package's initial value, wherever it runs: XLA computes the linspace
    as ``fma(i, f32(16·f32(1/(h−1))), 1 − i·f32(1/(h−1)))`` and the log as
    :func:`_xla_log` (checked bit for bit at the configurations' head
    counts, 16, 64 and 128)."""
    if h == 1:
        lin = torch.ones((1,), dtype=torch.float32)
    else:
        i = torch.arange(h - 1, dtype=torch.float32)
        r = torch.tensor(1.0, dtype=torch.float32) / (h - 1)
        lin = torch.cat([_fma(i, 16.0 * r, 1.0 - i * r),
                         torch.full((1,), 16.0)])
    return _xla_log(lin)


def init(cfg: ModelConfig, generator, device=None, dtype=torch.float32):
    """The global weights (every head; the model axis splits them by
    :func:`pspecs`)."""
    d, di, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    h, w = cfg.ssm_heads, cfg.ssm_conv
    dense = lambda shape, fan_in: common.dense_init(shape, fan_in, generator,
                                                    device, dtype)
    return {
        "wz": dense((d, di), d),
        "wx": dense((d, di), d),
        "wB": dense((d, n), d),
        "wC": dense((d, n), d),
        "wdt": dense((d, h), d),
        "conv_x": dense((w, di), w),    # randn / sqrt(w)
        "dt_bias": torch.zeros((h,), device=device, dtype=dtype),
        "A_log": _a_log(h).to(device=device, dtype=dtype),
        "D": torch.ones((h,), device=device, dtype=dtype),
        "norm_scale": torch.ones((di,), device=device, dtype=dtype),
        "out_proj": dense((di, d), di),
    }


def pspecs(cfg: ModelConfig):
    return {
        "wz": P(None, "model"),
        "wx": P(None, "model"),
        "wB": P(None, None),
        "wC": P(None, None),
        "wdt": P(None, "model"),
        "conv_x": P(None, "model"),
        "dt_bias": P("model"),
        "A_log": P("model"),
        "D": P("model"),
        "norm_scale": P("model"),
        "out_proj": P("model", None),
    }


def mspecs(cfg: ModelConfig):
    return {
        "wz": MatrixSpec("matrix", 0),
        "wx": MatrixSpec("matrix", 0),
        "wB": MatrixSpec("matrix", 0),
        "wC": MatrixSpec("matrix", 0),
        "wdt": MatrixSpec("matrix", 0),
        "conv_x": SPEC_NONE,      # tiny depthwise filter: bias rule
        "dt_bias": SPEC_NONE,
        "A_log": SPEC_NONE,
        "D": SPEC_NONE,
        "norm_scale": SPEC_NONE,
        "out_proj": MatrixSpec("matrix", 0),
    }


def _sharded_gated_rmsnorm(y, z, scale, ctx: MeshCtx, d_inner_global: int,
                           eps: float = 1e-6):
    y = y * F.silu(z)
    ss = torch.sum(torch.square(y.float()), dim=-1, keepdim=True)
    # the replicated mean square is consumed by every rank's local y path:
    # its true cotangent is the sum of the per-rank partials (g)
    ss = common.grad_synced(ctx.psum_model(ss) / d_inner_global, ctx)
    return (y * torch.rsqrt(ss + eps)).to(y.dtype) * scale


def _causal_depthwise_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); kernel: (w, C): a causal depthwise convolution along
    S, summed tap by tap as the JAX package sums it."""
    w, s = kernel.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, w - 1, 0))
    out = torch.zeros_like(x)
    for i in range(w):
        out = out + xp[:, i:i + s] * kernel[i]
    return out


def forward(params, x: torch.Tensor, cfg: ModelConfig, ctx: MeshCtx = SINGLE,
            *, chunk: int = 64) -> torch.Tensor:
    """x: (B, S, d) replicated over the model axis → (B, S, d), likewise.
    S must be a multiple of ``min(chunk, S)``."""
    b, s, d = x.shape
    p = cfg.ssm_head_dim
    hl = params["wdt"].shape[1]              # local head count

    # x enters the column-parallel projections (wz/wx/wdt) here; the
    # replicated B/C projections feed the rank-local scan, so each gets its
    # own g after the product, from the raw x, so that the cotangent
    # reaching x through wB/wC is not summed twice
    x_loc = common.grad_synced(x, ctx)
    z = x_loc @ params["wz"]                                 # (B, S, di_l)
    xs = x_loc @ params["wx"]
    xs = F.silu(_causal_depthwise_conv(xs, params["conv_x"]))
    bmat = common.grad_synced(x @ params["wB"], ctx)         # (B, S, N)
    cmat = common.grad_synced(x @ params["wC"], ctx)
    dt = F.softplus((x_loc @ params["wdt"]) + params["dt_bias"])  # (B, S, hl)
    a_neg = -torch.exp(params["A_log"].float())              # (hl,)

    xh = xs.reshape(b, s, hl, p)
    y, _ = _ssd_scan(xh, dt, bmat, cmat, a_neg, chunk)
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(b, s, hl * p)

    y = _sharded_gated_rmsnorm(y, z, params["norm_scale"], ctx, cfg.ssm_d_inner)
    return ctx.psum_model(y @ params["out_proj"])


def _ssd_scan(xh, dt, bmat, cmat, a_neg, chunk: int):
    """Chunked SSD.  xh: (B, S, H, P), dt: (B, S, H), bmat/cmat: (B, S, N).

    Returns ``(y (B, S, H, P), final state h (B, H, N, P))``."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    lc = min(chunk, s)
    if s % lc:
        raise ValueError(f"sequence length {s} is no multiple of the SSD "
                         f"chunk {lc}")
    causal = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                   device=xh.device))[None, :, :, None]
    hst = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    ys = []
    for c0 in range(0, s, lc):
        xk = xh[:, c0:c0 + lc].float()              # (B, Lc, H, P)
        dtk = dt[:, c0:c0 + lc]                     # (B, Lc, H)
        bk, ck = bmat[:, c0:c0 + lc], cmat[:, c0:c0 + lc]   # (B, Lc, N)
        a = dtk.float() * a_neg
        cum = torch.cumsum(a, dim=1)                # inclusive
        # intra-chunk: scores_ij = C_i·B_j · exp(cum_i − cum_j) · dt_j (i ≥ j)
        cb = torch.einsum("bin,bjn->bij", ck, bk)
        decay = cum[:, :, None, :] - cum[:, None, :, :]     # (B, Lc, Lc, H)
        # the double where: exp(decay) overflows in the masked upper
        # triangle (decay > 0 there), and a where over inf has NaN gradient
        decay = torch.where(causal, decay, torch.zeros_like(decay))
        lmat = torch.where(causal, torch.exp(decay), torch.zeros_like(decay))
        scores = cb[..., None] * lmat * dtk[:, None, :, :]  # (B, i, j, H)
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, xk)
        # inter-chunk: y_i += C_i · (exp(cum_i) · h_in)
        y_inter = torch.einsum("bin,bhnp->bihp", ck, hst) * torch.exp(cum)[..., None]
        # state: h' = exp(cum_last) h + Σ_j exp(cum_last − cum_j) dt_j B_j ⊗ x_j
        cl = cum[:, -1, :]                          # (B, H)
        w = torch.exp(cl[:, None, :] - cum) * dtk   # (B, Lc, H)
        upd = torch.einsum("bjh,bjn,bjhp->bhnp", w, bk, xk)
        hst = torch.exp(cl)[:, :, None, None] * hst + upd
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1).to(xh.dtype)
    return y, hst
