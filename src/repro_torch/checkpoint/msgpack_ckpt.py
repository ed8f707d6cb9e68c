"""Tree checkpoints in the JAX package's v2 envelope (port of
``repro.checkpoint.msgpack_ckpt``).

An envelope is one MessagePack map, ``{"version", "step", "treedef",
"meta", "leaves", "crc32"}``; each leaf is ``{"kind", "dtype", "shape",
"data", "path"}`` (``{"kind": "none", "path"}`` for ``None``), ``data`` the
leaf's raw little-endian bytes, ``path`` its ``jax.tree_util.keystr``
string and ``crc32`` the checksum of all leaves' bytes in order.  The
bytes are the JAX package's (:mod:`repro_torch.checkpoint.codec` gives
``msgpack.packb``'s output), so an envelope either package writes restores
in the other.  Trees are nested ``dict``s (sorted keys, paths
``['key']``), lists and tuples (``[i]``) and dataclasses (fields in
declaration order, paths ``.name``) over tensors, numpy arrays and
``None``.  Dtype tokens are numpy's ``.str`` (``<f4``, ``<i4``, ``|b1``, …)
and ``bfloat16``, whose bytes go through torch (``ml_dtypes`` is not
needed).

Declared divergence: ``treedef`` is ``str(treedef)`` of a JAX ``PyTreeDef``
in the JAX package and a structure string of the port's own here; neither
package reads it on restore.

Size and memory: a leaf's ``bin`` holds at most 2³² − 1 bytes, and a
save that has a larger leaf raises :class:`CheckpointError` naming it
before anything is written.  A save streams each leaf to the file in
pieces (a device tensor's through a few reused pinned host buffers),
computing the checksum as it goes, while a thread writes the previous
piece; a
restore checks the checksum in one pass over the file (a thread reading
ahead) and then reads each leaf straight into the template's tensor where
shapes agree, so neither side holds a second copy of the state.

Durability, as in the JAX package: one writer per directory; the file is
written to a ``*.tmp`` of :func:`tempfile.mkstemp`, fsynced, moved into
place with ``os.replace`` and the directory fsynced; orphaned ``*.tmp``
files are swept by the next save; :func:`restore_checkpoint` raises
:class:`CheckpointError`, never returns garbage, on truncated, corrupted or
mismatched envelopes.  v1 envelopes (no version, meta, paths or crc)
restore too; writes are always v2.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import re
import tempfile
import threading
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import codec

FORMAT_VERSION = 2

# meta key of the model-parallel degree the envelope was saved at (with
# "mesh_shape"); the port has no model axis yet (ROADMAP queue A, item
# 14), so it saves at 1 and restores only envelopes saved at 1
MODEL_AXIS_KEY = "model_axis_size"

_CKPT_RE = re.compile(r"ckpt_(\d+)\.msgpack")
_PIECE = 64 << 20        # bytes a save or restore moves at a time

_TORCH_TOKENS = {torch.float32: "<f4", torch.float64: "<f8",
                 torch.float16: "<f2", torch.bfloat16: "bfloat16",
                 torch.int8: "|i1", torch.uint8: "|u1", torch.int16: "<i2",
                 torch.int32: "<i4", torch.int64: "<i8", torch.bool: "|b1"}
for _name, _token in (("uint16", "<u2"), ("uint32", "<u4"), ("uint64", "<u8")):
    if hasattr(torch, _name):
        _TORCH_TOKENS[getattr(torch, _name)] = _token
_TOKEN_TORCH = {v: k for k, v in _TORCH_TOKENS.items()}


class CheckpointError(RuntimeError):
    """A checkpoint could not be read back, or cannot be written: a
    truncated or corrupted file, an envelope that does not match the
    restore template (named by tree path), or a leaf too large for one
    ``bin``."""


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``(path piece, child)`` pairs of a container, ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in ``jax.tree_util`` order."""
    out = []
    _walk(tree, "", out)
    return out


# module-level recursion, not a nested closure: a closure that calls itself
# is a reference cycle, which would keep the leaves it saw (a save's whole
# state) alive until the garbage collector runs
def _walk(node, path: str, out: list) -> None:
    kids = _children(node)
    if kids is None:
        out.append((path, node))
    else:
        for piece, child in kids:
            _walk(child, path + piece, out)


def unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in flatten order."""
    it = iter(leaves)
    out = _build(like, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


def _build(node, it):
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(x, it) for x in node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: _build(getattr(node, f.name), it)
            for f in dataclasses.fields(node)})
    return next(it)


def _structure(node) -> str:
    """The tree's shape with ``*`` for each array leaf (the ``treedef``
    string the port writes)."""
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(node[k])}"
                               for k in sorted(node)) + "}"
    if isinstance(node, (list, tuple)):
        return "[" + ", ".join(_structure(x) for x in node) + "]"
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return f"{type(node).__name__}(" + ", ".join(
            f"{f.name}={_structure(getattr(node, f.name))}"
            for f in dataclasses.fields(node)) + ")"
    return "None" if node is None else "*"


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def dtype_token(x) -> str:
    """The envelope's dtype token of a tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _TORCH_TOKENS:
            raise CheckpointError(f"no envelope dtype for {x.dtype}")
        return _TORCH_TOKENS[x.dtype]
    dt = np.asarray(x).dtype
    return dt.name if dt.kind == "V" else dt.str


def _token_name(token: str) -> str:
    if token == "bfloat16":
        return token
    try:
        return np.dtype(token).name
    except TypeError:
        return token


def _as_array(x):
    return x if isinstance(x, (torch.Tensor, np.ndarray)) else np.asarray(x)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.nbytes)


def _byte_view(x) -> torch.Tensor:
    """A flat ``uint8`` tensor over ``x``'s bytes (a copy only where ``x``
    is not contiguous)."""
    if not isinstance(x, torch.Tensor):
        arr = np.ascontiguousarray(x).reshape(-1)
        return torch.from_numpy(arr.view(np.uint8))
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _leaf_record(x, sink: "_Sink") -> dict:
    """The leaf's envelope record; its ``data`` hands the leaf's bytes to
    ``sink`` a piece at a time."""
    if x is None:
        return {"kind": "none"}
    x = _as_array(x)

    def write_to(write):
        flat = _byte_view(x)
        for i in range(0, flat.numel(), _PIECE):
            sink.data(flat[i:i + _PIECE])

    return {"kind": "array", "dtype": dtype_token(x),
            "shape": [int(s) for s in x.shape],
            "data": codec.Deferred(_nbytes(x), write_to)}


def _data_chunks(data):
    if isinstance(data, codec.Blob):
        yield from data.chunks(_PIECE)
    else:
        yield data


def _prefetched(pieces, depth: int = 2):
    """Iterate ``pieces`` (file reads) in a thread of its own, up to
    ``depth`` pieces ahead, so that the reads overlap the caller's work on
    the previous piece (zlib's crc32 and file reads both release the
    interpreter lock)."""
    q, stop, done, errors = queue.Queue(depth), threading.Event(), object(), []

    def run():
        try:
            for piece in pieces:
                q.put(piece)
                if stop.is_set():
                    return
        except BaseException as e:  # handed to the consumer, re-raised there
            errors.append(e)
        finally:
            q.put(done)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        while (piece := q.get()) is not done:
            yield piece
    finally:
        stop.set()
        while thread.is_alive():    # unblock a producer waiting on put
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()
    if errors:
        raise errors[0]


class _Sink:
    """Where a save's bytes go.  A thread of its own writes them to the file
    ``f`` in order, so that the caller's next piece (its copy to the host,
    its crc32) overlaps this one's write; at most ``depth`` pieces wait.  A
    device tensor's pieces pass through a few pinned host buffers, reused
    once written.  :meth:`close` waits for the last write and re-raises a
    write's error."""

    def __init__(self, f, depth: int = 3):
        self.f, self.crc, self.error = f, 0, None
        self.q = queue.Queue(depth)
        self.free, self.pinned = queue.Queue(), 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while (item := self.q.get()) is not None:
            buf, release = item
            if self.error is None:
                try:
                    self.f.write(buf)
                except BaseException as e:  # re-raised by write/close
                    self.error = e
            if release is not None:
                release()

    def write(self, buf, release=None) -> None:
        if self.error is not None:
            raise self.error
        self.q.put((buf, release))

    def data(self, piece: torch.Tensor) -> None:
        """One piece of a leaf's bytes (flat ``uint8``, any device): folded
        into the checksum and queued for the file."""
        release = None
        if piece.device.type != "cpu":
            if self.free.empty() and self.pinned < self.q.maxsize + 2:
                self.pinned += 1
                whole = torch.empty(_PIECE, dtype=torch.uint8, pin_memory=True)
            else:
                whole = self.free.get()
            piece = whole[:piece.numel()].copy_(piece)
            release = lambda: self.free.put(whole)
        buf = memoryview(piece.numpy())
        self.crc = zlib.crc32(buf, self.crc)
        self.write(buf, release)

    def close(self) -> None:
        self.q.put(None)
        self.thread.join()
        if self.error is not None:
            raise self.error


def _leaves_crc(records) -> int:
    crc = 0
    for piece in _prefetched(piece for d in records if d["kind"] == "array"
                             for piece in _data_chunks(d["data"])):
        crc = zlib.crc32(piece, crc)
    return crc


class ZeroBytes:
    """The ``data`` of a leaf record whose bytes are all zero, held as a
    length only: a restore zeroes the template's tensor in place (a
    zero-filled in-flight aggregate, built by
    :func:`repro_torch.checkpoint.train_state.restore_train_state` without
    a buffer of its size)."""

    def __init__(self, nbytes: int):
        self.nbytes = int(nbytes)

    def __len__(self) -> int:
        return self.nbytes


def _fill(dst: torch.Tensor, data) -> None:
    """Copy the envelope bytes ``data`` into the contiguous tensor ``dst``
    (any device), a piece at a time."""
    flat = dst.view(-1).view(torch.uint8)
    if len(data) != flat.numel():
        raise CheckpointError(f"{len(data)} bytes for a leaf of "
                              f"{flat.numel()}")
    if isinstance(data, ZeroBytes):
        flat.zero_()
        return
    if not len(data):
        return
    if dst.device.type == "cpu":
        if isinstance(data, codec.Blob):
            data.readinto(flat.numpy())
        else:
            flat.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
        return
    # one pinned piece, reused: each copy_ returns once the piece is on the
    # card, so the next read may overwrite it
    host = torch.empty(min(_PIECE, flat.numel()), dtype=torch.uint8,
                       pin_memory=True)
    if not isinstance(data, codec.Blob):
        host = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        flat.copy_(host)
        return
    done = 0
    for n in data.pieces_into(host.numpy()):
        flat[done:done + n].copy_(host[:n])
        done += n


def decode_leaf(d: dict, like=None, device="cpu"):
    """A leaf record as a new tensor on ``device`` (``None`` for a none
    record); as a numpy array when ``like`` is one."""
    if d["kind"] == "none":
        return None
    token, shape = d["dtype"], tuple(d["shape"])
    if isinstance(like, (np.ndarray, np.generic)) or token not in _TOKEN_TORCH:
        data = d["data"]
        raw = (data.tobytes() if isinstance(data, codec.Blob)
               else bytes(len(data)) if isinstance(data, ZeroBytes)
               else bytes(data))
        return np.frombuffer(raw, dtype=np.dtype(token)).reshape(shape).copy()
    out = torch.empty(shape, dtype=_TOKEN_TORCH[token], device=device)
    _fill(out, d["data"])
    return out


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:010d}.msgpack")


def _sweep_orphaned_tmp(directory: str):
    """Remove ``*.tmp`` files a crashed writer left (one writer per
    directory makes this safe)."""
    for name in os.listdir(directory):
        if name.endswith(".tmp"):
            try:
                os.remove(os.path.join(directory, name))
            except FileNotFoundError:
                pass


def _fsync_dir(directory: str):
    """Make a completed rename durable: the directory entry lives in the
    directory's inode."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover - a file system without dir open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def check_leaf_sizes(pairs) -> None:
    """Raise :class:`CheckpointError` naming the first leaf of ``(path,
    leaf)`` pairs whose bytes do not fit one ``bin`` (2³² − 1)."""
    for path, x in pairs:
        if x is not None and _nbytes(_as_array(x)) > codec.BIN_MAX:
            raise CheckpointError(
                f"leaf {path}: {_nbytes(_as_array(x)):,} bytes, more than "
                f"one MessagePack bin holds ({codec.BIN_MAX:,}); the v2 "
                f"envelope cannot store it")


def save_checkpoint(directory: str, step: int, tree: Any, *, keep: int = 3,
                    meta: Optional[dict] = None) -> str:
    """Write ``tree`` as ``ckpt_<step>.msgpack`` in ``directory``, keeping
    the newest ``keep`` checkpoints there; returns the file's path."""
    pairs = flatten_with_paths(tree)
    check_leaf_sizes(pairs)
    os.makedirs(directory, exist_ok=True)
    _sweep_orphaned_tmp(directory)
    path = _ckpt_path(directory, step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            sink = _Sink(f)
            try:
                head = {"version": FORMAT_VERSION, "step": int(step),
                        "treedef": _structure(tree), "meta": meta or {},
                        "leaves": [dict(_leaf_record(x, sink), path=p)
                                   for p, x in pairs]}
                codec.pack_map_header(len(head) + 1, sink.write)
                for k, v in head.items():
                    codec.pack(k, sink.write)
                    codec.pack(v, sink.write)
                codec.pack("crc32", sink.write)
                codec.pack(sink.crc, sink.write)
            finally:
                sink.close()
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except FileNotFoundError:
            pass
        raise
    _fsync_dir(directory)
    _retain(directory, keep)
    return path


def load_envelope(directory: str, step: Optional[int] = None) -> dict:
    """Read and integrity-check one envelope without a template.

    Returns the payload dict (v1 payloads gain ``version=1`` and
    ``meta={}``); large leaf ``data`` stay in the file as
    :class:`~repro_torch.checkpoint.codec.Blob`s.  Raises
    :class:`CheckpointError` on truncated or corrupted files and
    ``FileNotFoundError`` when there is nothing to load."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = _ckpt_path(directory, step)
    try:
        payload = codec.unpack_file(path)
    except FileNotFoundError:
        raise
    except (ValueError, TypeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"{path}: not a valid checkpoint envelope (truncated or "
            f"corrupted): {e}") from e
    if (not isinstance(payload, dict) or "leaves" not in payload
            or "step" not in payload):
        raise CheckpointError(f"{path}: envelope missing required fields")
    payload.setdefault("version", 1)
    payload.setdefault("meta", {})
    if payload["version"] >= 2:
        got = _leaves_crc(payload["leaves"])
        if got != payload.get("crc32"):
            raise CheckpointError(
                f"{path}: leaf-data checksum mismatch "
                f"(crc32 {got:#010x} != recorded "
                f"{payload.get('crc32', 0):#010x}) — corrupted buffers")
    return payload


def checkpoint_meta(directory: str, step: Optional[int] = None) -> dict:
    """The ``meta`` dict saved with a checkpoint (``{}`` for v1)."""
    return load_envelope(directory, step)["meta"]


def check_model_axis(meta: dict, model_axis_size: int):
    """Refuse an envelope saved at another model-parallel degree (its
    model-local factors are stacked per model rank and cannot be
    re-sliced); raises :class:`CheckpointError` naming both sizes."""
    saved = int(meta.get(MODEL_AXIS_KEY, 1) or 1)
    if saved != int(model_axis_size):
        raise CheckpointError(
            f"model-parallel degree mismatch: checkpoint was saved at "
            f"{MODEL_AXIS_KEY}={saved}, this run restores at "
            f"{MODEL_AXIS_KEY}={int(model_axis_size)} — model-local state "
            f"(per-rank warm-start factors) cannot be re-sliced across "
            f"model degrees; restore on a mesh with {saved} model shard(s)")


def restore_tree(payload: dict, template: Any, shape_ok=None) -> Any:
    """Decode an envelope's leaves into the structure of ``template``.

    Structure (leaf count and stored paths), none-or-array and dtype are
    checked strictly; shapes must match unless ``shape_ok(path, got_shape,
    want_shape)`` approves.  Mismatches raise :class:`CheckpointError`
    naming the tree path, before any leaf is read.  A leaf whose template
    is a contiguous tensor of its shape is read into that tensor in place
    (the returned tree holds the template's tensors); any other becomes a
    new tensor on the template leaf's device (a numpy array where the
    template holds one, a CPU tensor where it is on the ``meta`` device)."""
    t_pairs = flatten_with_paths(template)
    encoded = payload["leaves"]
    if len(encoded) != len(t_pairs):
        raise CheckpointError(
            f"checkpoint/template structure mismatch: {len(encoded)} leaves "
            f"in checkpoint, {len(t_pairs)} in template")
    for d, (tpath, want) in zip(encoded, t_pairs):
        path = d.get("path", tpath)  # v1 has no stored paths
        if path != tpath:
            raise CheckpointError(
                f"checkpoint/template structure mismatch at {tpath}: "
                f"checkpoint leaf is {path}")
        got_none = d["kind"] == "none"
        if got_none != (want is None):
            raise CheckpointError(
                f"leaf {tpath}: checkpoint has "
                f"{'None' if got_none else 'an array'}, template has "
                f"{'None' if want is None else 'an array'}")
        if got_none:
            continue
        want = _as_array(want)
        if d["dtype"] != dtype_token(want):
            raise CheckpointError(
                f"leaf {tpath}: dtype mismatch — checkpoint "
                f"{_token_name(d['dtype'])}, template "
                f"{_token_name(dtype_token(want))}")
        gs, ws = tuple(d["shape"]), tuple(want.shape)
        if gs != ws and not (shape_ok and shape_ok(tpath, gs, ws)):
            raise CheckpointError(
                f"leaf {tpath}: shape mismatch — checkpoint {gs}, "
                f"template {ws}")
    leaves = []
    for d, (_, want) in zip(encoded, t_pairs):
        device = want.device if isinstance(want, torch.Tensor) else "cpu"
        if device == torch.device("meta"):     # shapes alone: a new host tensor
            leaves.append(decode_leaf(d, like=want, device="cpu"))
        elif (isinstance(want, torch.Tensor) and want.is_contiguous()
                and tuple(d["shape"]) == tuple(want.shape)):
            _fill(want, d["data"])
            leaves.append(want)
        else:
            leaves.append(decode_leaf(d, like=want, device=device))
    return unflatten(template, leaves)


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (:func:`restore_tree`)."""
    payload = load_envelope(directory, step)
    return restore_tree(payload, template), payload["step"]


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def all_steps(directory: str) -> list:
    """Sorted steps of every checkpoint currently in ``directory``."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in
                  (_CKPT_RE.fullmatch(n) for n in os.listdir(directory)) if m)


def _retain(directory: str, keep: int):
    for s in all_steps(directory)[:-keep]:
        try:
            os.remove(_ckpt_path(directory, s))
        except FileNotFoundError:
            pass  # a concurrent cleaner already removed it
