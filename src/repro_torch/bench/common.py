"""The benchmark LM every paper table trains, and the paper's α-β
communication model (port of ``LMSpec``, ``_make_cfg``, ``payload_floats``,
``train_lm``, ``comm_time``, ``broadcast_time``, ``measure_coding_time`` and
``bytes_per_epoch_mb`` of the JAX package's ``benchmarks/common.py``).

:func:`train_lm` trains a small dense transformer LM on order-1 Markov data
under error feedback and a compressor, with W simulated workers on one
device (:class:`~repro_torch.core.simmesh.SimMesh`): each worker's
gradient on its own batch shard, Δ = g + e, the compressor's fused step,
e ← Δ − recon, and the update ``m ← λm + agg``, ``x ← x − lr·(agg + m)`` at
a constant learning rate without weight decay (the error-feedback step of
:func:`repro_torch.core.error_feedback.apply_updates`).  Shared-seed
draws take the seed of each step from the base seed :data:`RUN_SEED` (the
JAX package's ``fold_in(key(123), step)``).

    from repro_torch.bench.common import LMSpec, train_lm
    from repro_torch.core.compressors import make_compressor
    train_lm(make_compressor("powersgd", rank=2), LMSpec(), device="cpu")

It runs on the CUDA card unless ``device`` says otherwise.  Not ported yet:
adaptive-rank controllers (ROADMAP queue A, item 8) and
``init_comp_transform`` (the autotuner's plans, item 9).

The α-β constants (:data:`BW`, :data:`LATENCY`) model the paper's cluster
(Appendix B: 10 Gbit/s Ethernet, NCCL-like and GLOO-like backends); they
are not figures of any card the port runs on.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import LayerSlot, ModelConfig
from repro_torch.core import error_feedback, matrixize
from repro_torch.core.compressors import Compressor
from repro_torch.core.dist import SINGLE
from repro_torch.core.error_feedback import EFState
from repro_torch.core.simmesh import SimMesh
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch.train import resolve_device, worker_grads
from repro_torch.models import model

Q_CHUNK = 32
EVAL_BATCH = 32
EVAL_STEP0 = 10_000   # eval batches are stream steps the training never reaches
RUN_SEED = 123        # base seed of the per-step shared-seed draws


@dataclasses.dataclass
class LMSpec:
    vocab: int = 256
    d_model: int = 128
    layers: int = 2
    heads: int = 4
    seq: int = 64
    batch_per_worker: int = 4
    workers: int = 4
    steps: int = 150
    lr: float = 0.1
    momentum: float = 0.9
    seed: int = 0
    # order-1 Markov with 8 token clusters: learnable within the step budget
    # and with genuinely low-rank gradients (the paper's premise, §2)
    order: int = 1
    clusters: int = 8


def _make_cfg(spec: LMSpec) -> ModelConfig:
    return ModelConfig(
        name="bench-lm", arch_type="dense", num_layers=spec.layers,
        d_model=spec.d_model, num_heads=spec.heads, num_kv_heads=spec.heads,
        head_dim=spec.d_model // spec.heads, d_ff=spec.d_model * 4,
        vocab_size=spec.vocab, rope_theta=10000.0,
        slots=(LayerSlot("attn", "dense"),))


def model_buckets(cfg: ModelConfig):
    """The shape buckets the bucketed engine plans for ``cfg``'s compressed
    leaves (each with its ``count``, ``n`` and ``m``), found on the meta
    device, so it allocates nothing at any width."""
    shapes = []
    for p, spec in zip(tree.leaves(model.init(cfg, None, device="meta")),
                       tree.leaves(model.mspecs(cfg))):
        ms = matrixize.matrix_shape(tuple(p.shape), spec)
        shapes.append(None if ms is None else (math.prod(ms[0]), ms[1], ms[2]))
    return matrixize.plan_buckets(shapes).buckets


def payload_floats(params, specs, comp_state):
    """(compressed, uncompressed) floats one step sends per worker, at the
    ranks of the state's factors."""
    comp = unc = 0
    for p, sp, q in zip(tree.leaves(params), tree.leaves(specs),
                        tree.leaves(comp_state)):
        shape = tuple(p.shape)
        if q is None or matrixize.matrix_shape(shape, sp) is None:
            unc += matrixize.uncompressed_floats(shape)
        else:
            comp += matrixize.compressed_floats(shape, sp, q.shape[-1])
    return comp, unc


def _to(t, dev):
    """A copy of tree ``t`` on ``dev`` (the training updates it in place)."""
    return tree.map(lambda x: None if x is None else x.to(dev, copy=True), t)


def sync(dev: torch.device) -> None:
    """Wait for ``dev`` to finish its queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_data(spec: LMSpec) -> MarkovLM:
    return MarkovLM(vocab=spec.vocab, seed=spec.seed, order=spec.order,
                    clusters=spec.clusters)


def eval_set(data: MarkovLM, spec: LMSpec, batches: int, dev):
    """The held-out batches: stream steps the training never reaches."""
    out = []
    for i in range(batches):
        b = torch.tensor(data.sample(EVAL_BATCH, spec.seq, step=EVAL_STEP0 + i),
                         device=dev)
        out.append({"tokens": b[:, :-1], "labels": b[:, 1:]})
    return out


def eval_loss(params, cfg: ModelConfig, batches) -> float:
    """Mean loss of ``params`` over the held-out ``batches``."""
    with torch.no_grad():
        return float(np.mean([model.loss_fn(params, b, cfg, q_chunk=Q_CHUNK)[0].item()
                              for b in batches]))


def probe_bits(compressor: Compressor, params, specs, seed: int = 0) -> int:
    """``bits_per_worker`` of one step of ``compressor`` on zeros shaped like
    ``params``, on their device, from a state initialized with ``seed``
    (the bits depend on the shapes alone)."""
    zeros = tree.map(torch.zeros_like, params)
    dev = tree.leaves(zeros)[0].device
    state = compressor.init(zeros, specs, torch.Generator(dev).manual_seed(seed))
    return int(compressor.step(zeros, state, specs, ctx=SINGLE,
                               seed=RUN_SEED).bits_per_worker)


def train_lm(compressor: Compressor, spec: LMSpec = LMSpec(),
             eval_batches: int = 8, controller=None, init_comp_transform=None,
             *, device=None, params=None, comp_state=None, stats=None,
             return_params: bool = False):
    """Train the benchmark LM under EF + ``compressor`` with ``spec.workers``
    simulated workers.  Returns the JAX package's result dict (compressor,
    eval_loss, eval_ppl, bits_per_worker_per_step, allreduce, train_time_s,
    steps, workers, compressed_floats_total) plus ``step_ms``: the host
    time of every training step, each ending when the device has finished.

    ``params`` and ``comp_state`` (trees of tensors, copied) replace the
    random initial parameters and compressor state, which are otherwise
    drawn on the CPU from a generator seeded with ``spec.seed``.
    ``stats`` (a :class:`~repro_torch.core.dist.CollectiveStats`) records
    every training step's collectives.  ``return_params=True`` returns
    ``(result, params)``, the trained parameters on ``device``.
    """
    if controller is not None:
        raise NotImplementedError(
            "adaptive-rank controllers are not ported yet (ROADMAP queue A, "
            "item 8)")
    if init_comp_transform is not None:
        raise NotImplementedError(
            "init_comp_transform (autotuner plans) is not ported yet (ROADMAP "
            "queue A, item 9)")
    dev = resolve_device(device)
    cfg = _make_cfg(spec)
    specs = model.mspecs(cfg)
    gen = torch.Generator().manual_seed(spec.seed)
    if params is None:
        params = model.init(cfg, gen, device="cpu")
    if comp_state is None:
        comp_state = compressor.init(_to(params, "cpu"), specs, gen)
    params = _to(params, dev)
    sim = SimMesh(spec.workers)
    ctx = sim.ctx(stats=stats)
    state = EFState(
        error=tree.map(lambda p: torch.zeros((spec.workers,) + tuple(p.shape),
                                             dtype=p.dtype, device=dev), params),
        momentum=tree.map(torch.zeros_like, params),
        comp=_to(comp_state, dev), step=0)

    data = lm_data(spec)
    it = data.batches(spec.batch_per_worker * spec.workers, spec.seq)
    eval_data = eval_set(data, spec, eval_batches, dev)

    t0 = time.time()
    bits = None
    # stateful schemes (PowerSGD's Q factors) send a fixed payload per step;
    # stateless ones fall back to the probe's bits below
    stateful = state.comp is not None
    step_floats = payload_floats(params, specs, state.comp) if stateful else (0, 0)
    floats_sent = 0
    step_ms = []
    for _ in range(spec.steps):
        floats_sent += step_floats[0]
        batch = sim.shard({k: torch.tensor(v, device=dev)
                           for k, v in next(it).items()})
        ts = time.perf_counter()
        grads, _ = worker_grads(cfg, params, batch, spec.workers,
                                q_chunk=Q_CHUNK, device=dev)
        params, state, _ = error_feedback.apply_updates(
            compressor, params, grads, state, specs, lr=spec.lr,
            momentum=spec.momentum, ctx=ctx, seed=RUN_SEED)
        sync(dev)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if bits is None:
            bits = probe_bits(compressor, params, specs, spec.seed)
    train_time = time.time() - t0

    ev = eval_loss(params, cfg, eval_data)
    result = {
        "compressor": compressor.name,
        "eval_loss": ev,
        "eval_ppl": float(np.exp(ev)),
        "bits_per_worker_per_step": int(bits),
        "allreduce": compressor.allreduce,
        "train_time_s": train_time,
        "steps": spec.steps,
        "workers": spec.workers,
        # cumulative compressed floats over the run; stateless schemes count
        # the probe's payload
        "compressed_floats_total": (int(floats_sent) if stateful
                                    else int(bits) // 32 * spec.steps),
        "step_ms": step_ms,
    }
    return (result, params) if return_params else result


# ---------------------------------------------------------------------------
# communication model (the paper's Appendix B cluster: 10 Gbit/s Ethernet)
# ---------------------------------------------------------------------------

BW = {"nccl_10gbit": 10e9 / 8, "gloo_10gbit": 2.5e9 / 8}
LATENCY = {"nccl_10gbit": 30e-6, "gloo_10gbit": 150e-6}


def comm_time(bytes_per_worker: float, workers: int, allreduce: bool,
              backend: str = "nccl_10gbit") -> float:
    """Modeled seconds to aggregate one step's messages among ``workers``.

    ``bytes_per_worker`` is the payload one worker contributes.  An
    all-reduce costs ``2(W−1)/W · bytes / bw`` plus ``⌈log2 W⌉`` latencies;
    an all-gather ``(W−1) · bytes / bw`` plus ``W−1`` latencies, since every
    worker receives every other worker's payload.
    """
    bw = BW[backend]
    lat = LATENCY[backend]
    if workers <= 1:
        return 0.0
    if allreduce:
        rounds = math.ceil(math.log2(workers))
        return 2 * (workers - 1) / workers * bytes_per_worker / bw + lat * rounds
    return (workers - 1) * bytes_per_worker / bw + lat * (workers - 1)


def broadcast_time(bytes_root: float, workers: int,
                   backend: str = "nccl_10gbit") -> float:
    """Modeled seconds for rank 0 to broadcast ``bytes_root`` to W−1
    receivers (scatter + all-gather: half an all-reduce's bandwidth term,
    the same ``⌈log2 W⌉`` latencies)."""
    if workers <= 1:
        return 0.0
    rounds = math.ceil(math.log2(workers))
    return ((workers - 1) / workers * bytes_root / BW[backend]
            + LATENCY[backend] * rounds)


def measure_coding_time(compressor: Compressor, params, specs,
                        iters: int = 5, *, device=None) -> float:
    """Measured seconds of one compress + aggregate + decompress step of
    ``compressor`` on ``params``' shapes (gradients of 0.01 everywhere), on
    ``device`` (the CUDA card unless it says otherwise): one warm-up call,
    then ``iters`` calls with seeds ``RUN_SEED + i`` on the host clock, the
    device synchronized before and after.  The calls run eagerly, so the
    time includes the host's work around each kernel."""
    dev = resolve_device(device)
    params = tree.map(lambda x: x.to(dev), params)
    state = compressor.init(params, specs, torch.Generator(dev).manual_seed(0))
    grads = tree.map(lambda p: torch.ones_like(p) * 0.01, params)
    compressor.step(grads, state, specs, seed=RUN_SEED)
    sync(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        compressor.step(grads, state, specs, seed=RUN_SEED + i)
    sync(dev)
    return (time.perf_counter() - t0) / iters


def bytes_per_epoch_mb(bits_per_step: int, steps_per_epoch: int) -> float:
    return bits_per_step / 8 / 1e6 * steps_per_epoch
