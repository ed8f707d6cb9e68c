"""Nested-dict trees: the port's stand-in for ``jax.tree_util``.

Parameters, gradients, specs and compressor state are nested ``dict``s
whose leaves are tensors, :class:`~repro_torch.core.matrixize.MatrixSpec`s
or ``None``.  Leaves are visited in sorted-key order — the order
``jax.tree_util`` flattens a dict in — so leaf indices, and with them the
bucket plans built from them, agree with the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[str, ...]


def items(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in sorted-key order (``None`` is a leaf)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], path + (k,))
    else:
        yield path, tree


def leaves(tree: Any) -> List[Any]:
    return [x for _, x in items(tree)]


def unflatten(like: Any, values) -> Any:
    """A tree shaped like ``like`` holding ``values`` in leaf order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more values than leaves")
    return out


def map(fn: Callable, tree: Any, *rest: Any) -> Any:  # noqa: A001
    """``fn`` over aligned leaves of ``tree`` and ``rest``."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)
