"""Multi-layer LSTM language model, the paper's WikiText-2 benchmark (§5.3;
port of ``repro.models.lstm``).

Paper configuration (Appendix F, Table 11): vocab 28,869, embedding 650,
3 layers of hidden 650, 28,941,519 parameters.  The layouts are the JAX
package's: per layer ``rnn_ih_l{l}`` (4h × in), ``rnn_hh_l{l}`` (4h × h)
and one bias ``bias_l{l}`` (4h) — not torch's ``b_ih`` + ``b_hh`` — with
the gates in the order i, f, g, o and h₀ = c₀ = 0.  The decoder is tied to
the encoder (``logits = x @ encoderᵀ + decoder_b``), so the encoder's
gradient sums the lookup's and the decoder's.  The weight matrices are the
compression targets; biases fall under the bias rule.

The recurrence is an explicit loop over time with ``x @ W_ihᵀ`` hoisted out
of it; cuDNN's fused LSTM has another parameterisation and is not used.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.core.matrixize import NONE as SPEC_NONE, MatrixSpec
from repro_torch.models.common import embed_lookup


@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    vocab: int = 28869
    embed: int = 650
    hidden: int = 650
    layers: int = 3
    init_scale: float = 0.05   # encoder init std (the tied decoder with it)


def paper_lstm() -> LSTMConfig:
    return LSTMConfig()


def init(cfg: LSTMConfig, generator: Optional[torch.Generator] = None,
         device=None):
    """Parameters drawn from ``generator`` on ``device``: the encoder
    normal at ``init_scale``, ``1/√in`` normal LSTM weights, zero biases."""
    params = {"encoder": torch.randn((cfg.vocab, cfg.embed), generator=generator,
                                     device=device) * cfg.init_scale}
    h = cfg.hidden
    for l in range(cfg.layers):
        d_in = cfg.embed if l == 0 else h
        params[f"rnn_ih_l{l}"] = torch.randn(
            (4 * h, d_in), generator=generator, device=device) / math.sqrt(d_in)
        params[f"rnn_hh_l{l}"] = torch.randn(
            (4 * h, h), generator=generator, device=device) / math.sqrt(h)
        params[f"bias_l{l}"] = torch.zeros((4 * h,), device=device)
    params["decoder_b"] = torch.zeros((cfg.vocab,), device=device)
    return params


def mspecs(params):
    """Every matrix compressed, every vector uncompressed."""
    return tree.map(lambda p: MatrixSpec("matrix", 0) if p.ndim >= 2
                    else SPEC_NONE, params)


def _lstm_layer(x, w_ih, w_hh, bias):
    """``x``: ``(B, S, d_in)`` → ``(B, S, h)`` from h₀ = c₀ = 0."""
    b, seq, _ = x.shape
    xw = x @ w_ih.T + bias                       # (B, S, 4h), out of the loop
    h = c = x.new_zeros((b, w_hh.shape[1]))
    hs = []
    for t in range(seq):
        gates = xw[:, t] + h @ w_hh.T
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def forward(params, tokens, cfg: LSTMConfig):
    """``tokens`` ``(B, S)`` → logits ``(B, S, vocab)``."""
    x = embed_lookup(params["encoder"], tokens)
    for l in range(cfg.layers):
        x = _lstm_layer(x, params[f"rnn_ih_l{l}"], params[f"rnn_hh_l{l}"],
                        params[f"bias_l{l}"])
    return x @ params["encoder"].T + params["decoder_b"]


def loss_fn(params, batch, cfg: LSTMConfig):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``,
    both ``(B, S)``): ``(loss, {"loss", "ppl"})``."""
    logits = forward(params, batch["tokens"], cfg)
    loss = F.cross_entropy(logits.reshape(-1, cfg.vocab),
                           batch["labels"].reshape(-1).long())
    return loss, {"loss": loss, "ppl": torch.exp(loss)}
