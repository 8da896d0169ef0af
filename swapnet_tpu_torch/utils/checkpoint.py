"""Generator checkpoints in the JAX package's msgpack layout.

``swapnet_tpu/utils/checkpoint.py`` writes ``{label}_net_generator.msgpack``
(the generator's ``params`` tree) and, for batch norm,
``{label}_stats_generator.msgpack`` (``{"batch_stats": ...}``) with
``flax.serialization.to_bytes``.  The format is msgpack with one extension:
code 1 holds an ndarray as a nested msgpack (shape, dtype name, raw C-order
bytes); code 3 a numpy scalar in the same form.  Flax splits arrays over
1 GiB into ``__msgpack_chunked_array__`` maps.

The machine with the card may have no ``msgpack`` package, so this module
decodes and encodes that subset with the standard library alone.  Orbax
and ``.pth`` checkpoints are not read yet.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _array_from_payload(payload: bytes):
    shape, dtype_name, raw = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":  # not a numpy type: hand back a torch tensor
        flat = np.frombuffer(raw, dtype=np.uint16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(tuple(shape)).copy()


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_payload(data)
    if code == _EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f"unknown msgpack extension type {code}")


_FIXED = {  # marker: (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x9F or 0xDC <= b <= 0xDF:  # map / array
        if b <= 0x9F:
            n, is_map = b & 0x0F, b <= 0x8F
        else:
            size = 2 if b in (0xDC, 0xDE) else 4
            (n,) = struct.unpack_from(_LEN[size], buf, pos)
            pos += size
            is_map = b >= 0xDE
        if is_map:
            out = {}
            for _ in range(n):
                k, pos = _unpack(buf, pos)
                out[k], pos = _unpack(buf, pos)
            return _unchunk(out), pos
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    if 0xA0 <= b <= 0xBF or b in (0xD9, 0xDA, 0xDB, 0xC4, 0xC5, 0xC6):  # str / bin
        if b <= 0xBF:
            n = b & 0x1F
        else:
            size = {0xD9: 1, 0xDA: 2, 0xDB: 4, 0xC4: 1, 0xC5: 2, 0xC6: 4}[b]
            (n,) = struct.unpack_from(_LEN[size], buf, pos)
            pos += size
        raw = bytes(buf[pos:pos + n])
        return (raw if b in (0xC4, 0xC5, 0xC6) else raw.decode("utf-8")), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        fmt, size = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if 0xD4 <= b <= 0xD8 or b in (0xC7, 0xC8, 0xC9):  # fixext / ext
        if b >= 0xD4:
            n = 1 << (b - 0xD4)
        else:
            size = {0xC7: 1, 0xC8: 2, 0xC9: 4}[b]
            (n,) = struct.unpack_from(_LEN[size], buf, pos)
            pos += size
        (code,) = struct.unpack_from(">b", buf, pos)
        pos += 1
        return _ext(code, bytes(buf[pos:pos + n])), pos + n
    raise ValueError(f"unsupported msgpack marker 0x{b:02x} at byte {pos - 1}")


def _unchunk(d: dict):
    if d.get("__msgpack_chunked_array__") is not True:
        return d
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (with Flax's array extensions)."""
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"trailing bytes after msgpack object ({len(data) - pos})")
    return obj


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, small: Optional[int], m8: Optional[int],
              m16: int, m32: int, small_max: int) -> None:
    if small is not None and n <= small_max:
        out.append(small | n)
    elif m8 is not None and n < 1 << 8:
        out += struct.pack(">BB", m8, n)
    elif n < 1 << 16:
        out += struct.pack(">BH", m16, n)
    else:
        out += struct.pack(">BI", m32, n)


def _array_payload(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return packb([list(x.shape), "bfloat16", x.view(torch.uint16).numpy().tobytes()])
        x = x.numpy()
    return packb([list(x.shape), x.dtype.name, np.ascontiguousarray(x).tobytes()])


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            out += struct.pack(">BQ", 0xCF, obj)
        else:
            out += struct.pack(">Bq", 0xD3, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 0xD9, 0xDA, 0xDB, 31)
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0xC4, 0xC5, 0xC6, 0)
        out += obj
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, None, 0xDE, 0xDF, 15)
        for k, v in obj.items():
            _pack(str(k), out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, None, 0xDC, 0xDD, 15)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor, np.generic)):
        scalar = isinstance(obj, np.generic)
        payload = _array_payload(np.asarray(obj) if scalar else obj)
        _pack_len(out, len(payload), None, 0xC7, 0xC8, 0xC9, 0)
        out += struct.pack(">b", _EXT_NPSCALAR if scalar else _EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode ``obj`` as Flax's ``serialization.to_bytes`` would."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# generator checkpoints
# ---------------------------------------------------------------------------

def load_generator_weights(ckpt_dir: str, label: str = "latest") -> Tuple[dict, Optional[dict]]:
    """(params, extra) of a generator checkpoint; ``extra`` is the
    ``{"batch_stats": ...}`` tree when the checkpoint has one, else None."""
    path = os.path.join(ckpt_dir, f"{label}_net_generator.msgpack")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} (only msgpack generator checkpoints are read; orbax and "
            ".pth checkpoints are not ported yet)")
    with open(path, "rb") as f:
        params = unpackb(f.read())
    extra = None
    stats_path = os.path.join(ckpt_dir, f"{label}_stats_generator.msgpack")
    if os.path.exists(stats_path):
        with open(stats_path, "rb") as f:
            extra = unpackb(f.read())
    return params, extra


def save_generator_weights(ckpt_dir: str, label: str, variables: Dict[str, dict]) -> None:
    """Write ``{"params": ..., ["batch_stats": ...]}`` as the JAX package's
    generator files."""
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, f"{label}_net_generator.msgpack"), "wb") as f:
        f.write(packb(variables["params"]))
    extra = {k: v for k, v in variables.items() if k != "params"}
    if extra:
        with open(os.path.join(ckpt_dir, f"{label}_stats_generator.msgpack"), "wb") as f:
            f.write(packb(extra))
