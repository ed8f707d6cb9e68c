"""CIFAR ResNet-18, the paper's main benchmark model (§5; port of
``repro.models.resnet``).

The layouts are the JAX package's, so parameters cross between the two
packages as plain copies (:mod:`repro_torch.bridge`): convolution kernels
are ``(O, I, kh, kw)``, which the compressor's ``"conv"`` rule flattens to
the paper's ``O × I·kh·kw`` matrices (Table 10), and images enter
``(B, H, W, C)``; :func:`forward` runs in NCHW inside.

Convolutions pad as XLA's ``"SAME"`` does: the total padding of a spatial
dim is ``max((⌈n/s⌉ − 1)·s + k − n, 0)`` with the odd pixel at the end, so a
3×3 convolution at stride 2 pads an even input (0, 1), not (1, 1).

BatchNorm normalises with the biased batch variance in training and moves
its running state by ``0.9·old + 0.1·batch`` (mean and biased variance).
``F.batch_norm`` normalises, but the state update is computed here: the
running variance ``F.batch_norm`` keeps is the unbiased one.  The running
state is a tree of its own beside the parameters; BN scales and biases
fall under the paper's bias rule (aggregated uncompressed).

``width=64, blocks=(2, 2, 2, 2)`` is the paper's ResNet-18 (11,173,962
parameters).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.core.matrixize import NONE as SPEC_NONE, MatrixSpec

BN_MOMENTUM, BN_EPS = 0.9, 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    width: int = 64
    blocks: Tuple[int, ...] = (2, 2, 2, 2)
    num_classes: int = 10
    in_channels: int = 3


def paper_resnet18() -> ResNetConfig:
    return ResNetConfig(width=64, blocks=(2, 2, 2, 2), num_classes=10)


def _conv_init(o, i, kh, kw, generator, device):
    fan_in = i * kh * kw
    return torch.randn((o, i, kh, kw), generator=generator,
                       device=device) * math.sqrt(2.0 / fan_in)


def _bn_init(c, device):
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def _bn_state(c, device):
    return {"mean": torch.zeros((c,), device=device),
            "var": torch.ones((c,), device=device)}


def _stages(cfg: ResNetConfig):
    """``(name, in_c, out_c, stride)`` of every residual block, in order."""
    in_c = cfg.width
    for si, n in enumerate(cfg.blocks):
        out_c = cfg.width * (2 ** si)
        for bi in range(n):
            yield (f"layer{si}_{bi}", in_c, out_c,
                   2 if (si > 0 and bi == 0) else 1)
            in_c = out_c


def init(cfg: ResNetConfig, generator: Optional[torch.Generator] = None,
         device=None):
    """``(params, bn_state)``: He-normal convolutions and a ``1/√in``
    normal linear layer drawn from ``generator`` on ``device``, BN scales
    1 and biases 0, running means 0 and variances 1."""
    w = cfg.width
    params = {"conv1": _conv_init(w, cfg.in_channels, 3, 3, generator, device),
              "bn1": _bn_init(w, device)}
    state = {"bn1": _bn_state(w, device)}
    for name, in_c, out_c, stride in _stages(cfg):
        blk = {"conv1": _conv_init(out_c, in_c, 3, 3, generator, device),
               "bn1": _bn_init(out_c, device),
               "conv2": _conv_init(out_c, out_c, 3, 3, generator, device),
               "bn2": _bn_init(out_c, device)}
        bst = {"bn1": _bn_state(out_c, device), "bn2": _bn_state(out_c, device)}
        if stride != 1 or in_c != out_c:
            blk["shortcut"] = _conv_init(out_c, in_c, 1, 1, generator, device)
            blk["bn_s"] = _bn_init(out_c, device)
            bst["bn_s"] = _bn_state(out_c, device)
        params[name] = blk
        state[name] = bst
    in_c = w * 2 ** (len(cfg.blocks) - 1)
    params["linear"] = {
        "w": torch.randn((cfg.num_classes, in_c), generator=generator,
                         device=device) / math.sqrt(in_c),
        "b": torch.zeros((cfg.num_classes,), device=device)}
    return params, state


def mspecs(params):
    """Convolutions by the paper's ``(O, I·kh·kw)`` rule, the linear layer
    as a matrix, BN parameters and biases uncompressed."""
    def leaf(p):
        if p.ndim == 4:
            return MatrixSpec("conv", 0)
        if p.ndim == 2:
            return MatrixSpec("matrix", 0)
        return SPEC_NONE

    return tree.map(leaf, params)


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int):
    """``"SAME"`` convolution of NCHW ``x`` with an OIHW kernel."""
    (h0, h1), (w0, w1) = (_same_pads(x.shape[2], w.shape[2], stride),
                          _same_pads(x.shape[3], w.shape[3], stride))
    if (h0, w0) == (h1, w1):
        return F.conv2d(x, w, stride=stride, padding=(h0, w0))
    return F.conv2d(F.pad(x, (w0, w1, h0, h1)), w, stride=stride)


def _bn(x, p, s, train: bool):
    """BatchNorm over (N, H, W) of NCHW ``x``: ``(y, new_state)``.

    ``F.batch_norm`` normalises (with the biased batch variance in
    training) but owns no running state: the new state is computed here."""
    if not train:
        return F.batch_norm(x, s["mean"], s["var"], p["scale"], p["bias"],
                            training=False, eps=BN_EPS), s
    y = F.batch_norm(x, None, None, p["scale"], p["bias"], training=True,
                     eps=BN_EPS)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        new_s = {"mean": BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean,
                 "var": BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var}
    return y, new_s


def forward(params, state, x, cfg: ResNetConfig, train: bool = True):
    """``x``: ``(B, H, W, C)`` images → ``(logits (B, classes),
    new_bn_state)``; with ``train=False`` the carried BN state normalises
    and comes back unchanged."""
    new_state = {}
    h = _conv(x.permute(0, 3, 1, 2), params["conv1"], 1)
    h, new_state["bn1"] = _bn(h, params["bn1"], state["bn1"], train)
    h = F.relu(h)
    for name, _, _, stride in _stages(cfg):
        blk, bst = params[name], state[name]
        nst = {}
        y = _conv(h, blk["conv1"], stride)
        y, nst["bn1"] = _bn(y, blk["bn1"], bst["bn1"], train)
        y = F.relu(y)
        y = _conv(y, blk["conv2"], 1)
        y, nst["bn2"] = _bn(y, blk["bn2"], bst["bn2"], train)
        if "shortcut" in blk:
            sc = _conv(h, blk["shortcut"], stride)
            sc, nst["bn_s"] = _bn(sc, blk["bn_s"], bst["bn_s"], train)
        else:
            sc = h
        h = F.relu(y + sc)
        new_state[name] = nst
    h = h.mean(dim=(2, 3))
    logits = h @ params["linear"]["w"].T + params["linear"]["b"]
    return logits, new_state


def loss_fn(params, state, batch, cfg: ResNetConfig, train: bool = True):
    """Mean cross-entropy of ``batch`` (``images`` ``(B, H, W, C)``,
    ``labels`` ``(B,)``): ``(loss, (new_bn_state, {"loss", "acc"}))``."""
    logits, new_state = forward(params, state, batch["images"], cfg, train)
    labels = batch["labels"].long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, (new_state, {"loss": loss, "acc": acc})
