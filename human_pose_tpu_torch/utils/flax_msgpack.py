"""A reader of the JAX package's native trainer checkpoints, with neither
JAX, flax nor msgpack.

The JAX package's ``train/checkpoint.py::save_checkpoint`` pickles a dict
whose ``"module"`` is ``flax.serialization.to_bytes`` of ``{"step",
"params", "batch_stats", "opt_state"}``: msgpack (https://github.com/msgpack/
msgpack/blob/master/spec.md) of nested maps whose array leaves are flax's
extension types:

* code 1, an ndarray: the msgpack of ``(shape, dtype name, C-order bytes)``;
* code 2, a complex: the msgpack of ``(real, imag)``;
* code 3, a NumPy scalar: an ndarray of shape ``()``;

and arrays over 2**30 bytes are split into ``{"__msgpack_chunked_array__":
True, "shape": {"0": ...}, "chunks": {"0": ...}}``. ``unpackb`` decodes that
(maps, arrays, strings, binaries, ints, floats, nil, bools and the
extension types) into dicts, lists and NumPy arrays; bfloat16 leaves become
float32.

The pickle around it is read by ``RestrictedUnpickler``: builtins and the
NumPy classes a pickled array or scalar names, nothing else. A class of
``jax``, ``flax`` or ``optax`` is refused with its name and never imported.
"""

from __future__ import annotations

import builtins
import importlib
import pickle
import struct
from pathlib import Path
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A cursor over msgpack bytes; ``raw`` leaves strings as bytes (flax
    packs an ndarray's dtype name so)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = data, 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (wants {n} more)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        return _ext(code, self.take(n))

    def value(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I", 0xD9: "B", 0xDA: "H", 0xDB: "I",
                 0xDC: "H", 0xDD: "I", 0xDE: "H", 0xDF: "I", 0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return self.take(n)
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.string(n)
            if b <= 0xDD:
                return [self.value() for _ in range(n)]
            return self.map(n)
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at byte {self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":  # no NumPy dtype: the upper half of a float32
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    raise ValueError(f"msgpack: unknown extension type {code}")


def unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode one msgpack object of ``data`` (all of it)."""
    reader = _Reader(bytes(data), raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the object")
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the state dict of ``data``,
    chunked arrays put together."""
    return _unchunk(unpackb(data))


# -- the pickle around it ------------------------------------------------------------

_BUILTINS = frozenset({"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
                       "str", "bytes", "bytearray", "bool", "slice", "range"})
_NUMPY = {("numpy", "dtype"), ("numpy", "ndarray"),
          ("numpy.core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "scalar"),
          ("numpy._core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "scalar"),
          ("numpy.random._pickle", "__generator_ctor"),
          ("numpy.random._pickle", "__bit_generator_ctor"),
          ("numpy.random._pickle", "__randomstate_ctor")}
_JAX_ROOTS = frozenset({"jax", "jaxlib", "flax", "optax", "orbax"})


class RestrictedUnpickler(pickle.Unpickler):
    """Admits the builtins of plain data and the NumPy classes of arrays,
    scalars and generators; refuses any other class, naming it, without
    importing it."""

    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root in _JAX_ROOTS:
            raise pickle.UnpicklingError(
                f"the pickle names {module}.{name}, a class of {root}: the port imports no JAX "
                "package; save the checkpoint's arrays as NumPy (the JAX package's trainer "
                "checkpoint does) or export a flat npz (utils/export.py::export_weights_npz)")
        if module == "builtins" and name in _BUILTINS:
            return getattr(builtins, name)
        if (module, name) in _NUMPY:
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(f"the pickle names {module}.{name}, which this reader does "
                                     "not admit (builtins and NumPy arrays only)")


def load_pickle(path: str | Path) -> Any:
    """Unpickle ``path`` with ``RestrictedUnpickler``."""
    with open(path, "rb") as f:
        return RestrictedUnpickler(f).load()


def load_jax_trainer_checkpoint(path: str | Path) -> dict:
    """The flax variables ``{"params", "batch_stats"}`` of a JAX package
    trainer checkpoint (or of one whose module holds bare params) as nested
    dicts of NumPy arrays. Raises ``ValueError`` for anything else."""
    try:
        payload = load_pickle(path)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: {e}") from e
    if not isinstance(payload, dict) or not isinstance(payload.get("module"), bytes):
        raise ValueError(f"{path}: a pickle, but not a JAX trainer checkpoint (no msgpack 'module')")
    tree = msgpack_restore(payload["module"])
    params = tree.get("params", tree) if isinstance(tree, dict) else None
    if not params or not all(isinstance(v, dict) for v in params.values()):
        raise ValueError(f"{path}: a JAX trainer checkpoint whose module holds no params tree")
    variables = {"params": params}
    if tree.get("batch_stats"):
        variables["batch_stats"] = tree["batch_stats"]
    return variables
