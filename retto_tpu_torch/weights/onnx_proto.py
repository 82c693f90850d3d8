"""Minimal pure-Python ONNX protobuf codec.

Port copy of ``retto_tpu/weights/onnx_proto.py`` (pure numpy): the port
imports nothing of the JAX package, so it keeps its own copy.

The reference's entire L0 is ONNX Runtime loading ``.onnx`` protobufs
(ort_worker.rs:120-135); this module reads the same files with **zero
dependencies** (the ``onnx`` package is not available in this environment)
by decoding the protobuf wire format directly against the stable ONNX
schema field numbers.  An encoder for the same subset is included so the
bridge is testable hermetically (and models can be exported).

Covered messages: ModelProto, GraphProto, NodeProto, AttributeProto,
TensorProto, ValueInfoProto (+ nested type/shape messages) — everything
needed to reconstruct weights and topology of PP-OCR ONNX exports.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field as dfield
from typing import Any, Iterator

import numpy as np

__all__ = [
    "OnnxModel",
    "OnnxGraph",
    "OnnxNode",
    "OnnxTensor",
    "parse_model",
    "encode_model",
    "tensor_to_numpy",
]

# ---------------------------------------------------------------------- #
# wire primitives
# ---------------------------------------------------------------------- #


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v &= (1 << 64) - 1  # two's complement, 10 bytes
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, raw_value)."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 1:
            v = buf[pos : pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            v = buf[pos : pos + 4]
            pos += 4
        else:  # pragma: no cover - groups are not used by onnx
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, v


def _signed(v: int) -> int:
    """Interpret a varint as int64 (two's complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------- #
# decoded model structures
# ---------------------------------------------------------------------- #


@dataclass
class OnnxTensor:
    name: str = ""
    dims: list[int] = dfield(default_factory=list)
    data_type: int = 1
    raw_data: bytes = b""
    float_data: list[float] = dfield(default_factory=list)
    int32_data: list[int] = dfield(default_factory=list)
    int64_data: list[int] = dfield(default_factory=list)


@dataclass
class OnnxAttribute:
    name: str = ""
    type: int = 0  # 1 f, 2 i, 3 s, 4 t, 6 floats, 7 ints, 8 strings
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: OnnxTensor | None = None
    floats: list[float] = dfield(default_factory=list)
    ints: list[int] = dfield(default_factory=list)
    strings: list[bytes] = dfield(default_factory=list)

    def value(self) -> Any:
        if self.type == 1:
            return self.f
        if self.type == 2:
            return self.i
        if self.type == 3:
            return self.s.decode("utf-8", "replace")
        if self.type == 4:
            return self.t
        if self.type == 6:
            return list(self.floats)
        if self.type == 7:
            return list(self.ints)
        if self.type == 8:
            return [s.decode("utf-8", "replace") for s in self.strings]
        return None


@dataclass
class OnnxNode:
    op_type: str = ""
    name: str = ""
    inputs: list[str] = dfield(default_factory=list)
    outputs: list[str] = dfield(default_factory=list)
    attrs: dict[str, Any] = dfield(default_factory=dict)


@dataclass
class OnnxValueInfo:
    name: str = ""
    elem_type: int = 1
    shape: list[int | str | None] = dfield(default_factory=list)


@dataclass
class OnnxGraph:
    name: str = ""
    nodes: list[OnnxNode] = dfield(default_factory=list)
    initializers: dict[str, OnnxTensor] = dfield(default_factory=dict)
    inputs: list[OnnxValueInfo] = dfield(default_factory=list)
    outputs: list[OnnxValueInfo] = dfield(default_factory=list)


@dataclass
class OnnxModel:
    ir_version: int = 8
    producer: str = ""
    opset: int = 13
    graph: OnnxGraph = dfield(default_factory=OnnxGraph)


# ---------------------------------------------------------------------- #
# decoders (field numbers from onnx.proto, stable across releases)
# ---------------------------------------------------------------------- #


def _parse_tensor(buf: bytes) -> OnnxTensor:
    t = OnnxTensor()
    for fnum, wt, v in _fields(buf):
        if fnum == 1:  # dims
            t.dims.append(_signed(v) if wt == 0 else 0)
        elif fnum == 2:
            t.data_type = v
        elif fnum == 4:  # float_data (packed)
            if wt == 2:
                t.float_data.extend(
                    struct.unpack(f"<{len(v)//4}f", v)
                )
            else:
                t.float_data.append(struct.unpack("<f", v)[0])
        elif fnum == 5:  # int32_data packed varints
            if wt == 2:
                pos = 0
                while pos < len(v):
                    x, pos = _read_varint(v, pos)
                    t.int32_data.append(_signed(x))
            else:
                t.int32_data.append(_signed(v))
        elif fnum == 7:  # int64_data
            if wt == 2:
                pos = 0
                while pos < len(v):
                    x, pos = _read_varint(v, pos)
                    t.int64_data.append(_signed(x))
            else:
                t.int64_data.append(_signed(v))
        elif fnum == 8:
            t.name = v.decode("utf-8")
        elif fnum == 9:
            t.raw_data = v
    return t


_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def tensor_to_numpy(t: OnnxTensor) -> np.ndarray:
    dt = _DTYPES.get(t.data_type)
    if dt is None:
        raise ValueError(f"unsupported onnx data_type {t.data_type} for {t.name!r}")
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=dt)
    elif t.float_data:
        arr = np.asarray(t.float_data, dtype=dt)
    elif t.int64_data:
        arr = np.asarray(t.int64_data, dtype=dt)
    elif t.int32_data:
        arr = np.asarray(t.int32_data, dtype=dt)
    else:
        arr = np.zeros(0, dtype=dt)
    return arr.reshape(t.dims) if t.dims else arr.reshape(())


def _parse_attribute(buf: bytes) -> OnnxAttribute:
    a = OnnxAttribute()
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            a.name = v.decode("utf-8")
        elif fnum == 2:
            a.f = struct.unpack("<f", v)[0]
            a.type = a.type or 1
        elif fnum == 3:
            a.i = _signed(v)
            a.type = a.type or 2
        elif fnum == 4:
            a.s = v
            a.type = a.type or 3
        elif fnum == 5:
            a.t = _parse_tensor(v)
            a.type = a.type or 4
        elif fnum == 7:
            if wt == 2:
                a.floats.extend(struct.unpack(f"<{len(v)//4}f", v))
            else:
                a.floats.append(struct.unpack("<f", v)[0])
            a.type = a.type or 6
        elif fnum == 8:
            if wt == 2:
                pos = 0
                while pos < len(v):
                    x, pos = _read_varint(v, pos)
                    a.ints.append(_signed(x))
            else:
                a.ints.append(_signed(v))
            a.type = a.type or 7
        elif fnum == 9:
            a.strings.append(v)
            a.type = a.type or 8
        elif fnum == 20:
            a.type = v
    return a


def _parse_node(buf: bytes) -> OnnxNode:
    n = OnnxNode()
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            n.inputs.append(v.decode("utf-8"))
        elif fnum == 2:
            n.outputs.append(v.decode("utf-8"))
        elif fnum == 3:
            n.name = v.decode("utf-8")
        elif fnum == 4:
            n.op_type = v.decode("utf-8")
        elif fnum == 5:
            a = _parse_attribute(v)
            n.attrs[a.name] = a.value()
    return n


def _parse_value_info(buf: bytes) -> OnnxValueInfo:
    vi = OnnxValueInfo()
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            vi.name = v.decode("utf-8")
        elif fnum == 2:  # TypeProto
            for f2, _, v2 in _fields(v):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:  # Dimension
                                    dim: int | str | None = None
                                    for f5, _, v5 in _fields(v4):
                                        if f5 == 1:
                                            dim = _signed(v5)
                                        elif f5 == 2:
                                            dim = v5.decode("utf-8")
                                    vi.shape.append(dim)
    return vi


def _parse_graph(buf: bytes) -> OnnxGraph:
    g = OnnxGraph()
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(v))
        elif fnum == 2:
            g.name = v.decode("utf-8")
        elif fnum == 5:
            t = _parse_tensor(v)
            g.initializers[t.name] = t
        elif fnum == 11:
            g.inputs.append(_parse_value_info(v))
        elif fnum == 12:
            g.outputs.append(_parse_value_info(v))
    return g


def parse_model(data: bytes) -> OnnxModel:
    m = OnnxModel()
    for fnum, wt, v in _fields(data):
        if fnum == 1:
            m.ir_version = v
        elif fnum == 2:
            m.producer = v.decode("utf-8")
        elif fnum == 7:
            m.graph = _parse_graph(v)
        elif fnum == 8:  # opset_import
            for f2, _, v2 in _fields(v):
                if f2 == 2:
                    m.opset = _signed(v2)
    return m


# ---------------------------------------------------------------------- #
# encoder (subset; used for hermetic tests + model export)
# ---------------------------------------------------------------------- #


def _key(fnum: int, wt: int) -> bytes:
    return _write_varint(fnum << 3 | wt)


def _enc_bytes(fnum: int, b: bytes) -> bytes:
    return _key(fnum, 2) + _write_varint(len(b)) + b


def _enc_str(fnum: int, s: str) -> bytes:
    return _enc_bytes(fnum, s.encode("utf-8"))


def _enc_varint(fnum: int, v: int) -> bytes:
    return _key(fnum, 0) + _write_varint(v)


def _enc_float(fnum: int, v: float) -> bytes:
    return _key(fnum, 5) + struct.pack("<f", v)


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    dt_rev = {np.dtype(v): k for k, v in _DTYPES.items()}
    out = b""
    for d in arr.shape:
        out += _enc_varint(1, d)
    out += _enc_varint(2, dt_rev[arr.dtype])
    out += _enc_str(8, name)
    out += _enc_bytes(9, np.ascontiguousarray(arr).tobytes())
    return out


def _enc_attr(name: str, v: Any) -> bytes:
    body = _enc_str(1, name)
    if isinstance(v, float):
        body += _enc_float(2, v) + _enc_varint(20, 1)
    elif isinstance(v, bool) or isinstance(v, (int, np.integer)):
        body += _enc_varint(3, int(v)) + _enc_varint(20, 2)
    elif isinstance(v, str):
        body += _enc_bytes(4, v.encode()) + _enc_varint(20, 3)
    elif isinstance(v, np.ndarray):
        body += _enc_bytes(5, encode_tensor(name + "_t", v)) + _enc_varint(20, 4)
    elif isinstance(v, (list, tuple)) and v and isinstance(v[0], float):
        for x in v:
            body += _enc_float(7, x)
        body += _enc_varint(20, 6)
    elif isinstance(v, (list, tuple)):
        for x in v:
            body += _enc_varint(8, int(x))
        body += _enc_varint(20, 7)
    else:
        raise TypeError(f"unsupported attr {name}={v!r}")
    return body


def encode_node(
    op_type: str, inputs: list[str], outputs: list[str], **attrs: Any
) -> bytes:
    body = b""
    for i in inputs:
        body += _enc_str(1, i)
    for o in outputs:
        body += _enc_str(2, o)
    body += _enc_str(4, op_type)
    for k, v in attrs.items():
        body += _enc_bytes(5, _enc_attr(k, v))
    return body


def _enc_value_info(name: str, shape: list[int]) -> bytes:
    dims = b""
    for d in shape:
        dims += _enc_bytes(1, _enc_varint(1, d))  # Dimension.dim_value
    shape_msg = dims
    tensor_type = _enc_varint(1, 1) + _enc_bytes(2, shape_msg)
    type_proto = _enc_bytes(1, tensor_type)
    return _enc_str(1, name) + _enc_bytes(2, type_proto)


def encode_model(
    nodes: list[bytes],
    initializers: dict[str, np.ndarray],
    inputs: dict[str, list[int]],
    outputs: dict[str, list[int]],
    opset: int = 13,
) -> bytes:
    g = b""
    for n in nodes:
        g += _enc_bytes(1, n)
    g += _enc_str(2, "g")
    for name, arr in initializers.items():
        g += _enc_bytes(5, encode_tensor(name, arr))
    for name, shape in inputs.items():
        g += _enc_bytes(11, _enc_value_info(name, shape))
    for name, shape in outputs.items():
        g += _enc_bytes(12, _enc_value_info(name, shape))
    m = _enc_varint(1, 8)  # ir_version
    m += _enc_str(2, "retto-tpu")
    m += _enc_bytes(7, g)
    m += _enc_bytes(8, _enc_str(1, "") + _enc_varint(2, opset))
    return m
