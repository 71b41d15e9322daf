"""Minimal ONNX protobuf reader/writer (no `onnx`/`protobuf` dependency).

The environment has no onnx package, so this module speaks the protobuf
wire format directly for the subset of `onnx.proto` the importer needs:
ModelProto { graph }, GraphProto { node, initializer, input, output },
NodeProto { input, output, name, op_type, attribute }, AttributeProto
{ name, f, i, s, t, floats, ints, type }, TensorProto { dims, data_type,
float_data, int32_data, int64_data, name, raw_data }, ValueInfoProto
{ name, type.tensor_type.{elem_type, shape.dim.dim_value} }.

Field numbers follow the public onnx.proto schema. Reference counterpart:
the reference hands model.onnx to ONNX Runtime (model.cpp:825-1035); here
the graph is parsed and run as PyTorch ops on the device
(tpuserve_torch/onnx/importer.py). The writer exists so fixtures can emit
reference-compatible model.onnx files (tpuserve_torch/fixtures.py). This is
the port's own copy of tpuserve/onnx/proto.py (numpy and struct only).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------- wire format

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes) -> List[Tuple[int, int, object]]:
    """Decode a message into [(field_number, wire_type, raw_value)]."""
    out = []
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == _VARINT:
            val, i = _read_varint(buf, i)
        elif wt == _I64:
            val = buf[i : i + 8]
            i += 8
        elif wt == _LEN:
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wt == _I32:
            val = buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.append((field, wt, val))
    return out


def _group(fields) -> Dict[int, List]:
    d: Dict[int, List] = {}
    for f, _, v in fields:
        d.setdefault(f, []).append(v)
    return d


def _zigzag_i64(v: int) -> int:
    """Varints store int64 two's-complement; map back to signed."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_or_repeated(vals: List, fmt: Optional[str]) -> List:
    """Repeated scalar fields may arrive packed (one LEN blob) or as
    individual entries; `fmt` is the struct format for fixed-width types
    (None = varint)."""
    out: List = []
    for v in vals:
        if isinstance(v, (bytes, bytearray)):
            if fmt is None:  # packed varints
                i = 0
                while i < len(v):
                    x, i = _read_varint(v, i)
                    out.append(_zigzag_i64(x))
            else:
                size = struct.calcsize(fmt)
                out.extend(
                    struct.unpack_from("<" + fmt, v, off)[0]
                    for off in range(0, len(v), size)
                )
        else:
            out.append(_zigzag_i64(v) if fmt is None else v)
    return out


# ---------------------------------------------------------------- data model

# onnx TensorProto.DataType values
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64, DT_BOOL, DT_FLOAT16, DT_DOUBLE = (
    1, 2, 3, 6, 7, 9, 10, 11,
)

_NP_FROM_ONNX = {
    DT_FLOAT: np.float32,
    DT_UINT8: np.uint8,
    DT_INT8: np.int8,
    DT_INT32: np.int32,
    DT_INT64: np.int64,
    DT_BOOL: np.bool_,
    DT_FLOAT16: np.float16,
    DT_DOUBLE: np.float64,
}
_ONNX_FROM_NP = {np.dtype(v): k for k, v in _NP_FROM_ONNX.items()}


@dataclasses.dataclass
class TensorProto:
    name: str
    array: np.ndarray


@dataclasses.dataclass
class Attribute:
    name: str
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional[TensorProto] = None
    floats: List[float] = dataclasses.field(default_factory=list)
    ints: List[int] = dataclasses.field(default_factory=list)

    @property
    def value(self):
        for v in (self.t, self.s, self.f, self.i):
            if v is not None:
                return v
        return self.ints or self.floats


@dataclasses.dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, Attribute] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ValueInfo:
    name: str
    elem_type: int = DT_FLOAT
    shape: List[int] = dataclasses.field(default_factory=list)  # -1 = dynamic


@dataclasses.dataclass
class Graph:
    name: str
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[ValueInfo]
    outputs: List[ValueInfo]


# ---------------------------------------------------------------- parsing


def _parse_tensor(buf: bytes) -> TensorProto:
    g = _group(_fields(buf))
    dims = _packed_or_repeated(g.get(1, []), None)
    data_type = g.get(2, [DT_FLOAT])[0]
    name = g.get(8, [b""])[0].decode()
    np_dtype = _NP_FROM_ONNX.get(data_type)
    if np_dtype is None:
        raise ValueError(f"tensor '{name}': unsupported ONNX data_type {data_type}")
    if 9 in g:  # raw_data: little-endian layout of np_dtype
        arr = np.frombuffer(g[9][0], dtype=np.dtype(np_dtype).newbyteorder("<"))
    elif 4 in g and data_type in (DT_FLOAT,):
        arr = np.asarray(_packed_or_repeated(g[4], "f"), np.float32)
    elif 7 in g and data_type == DT_INT64:
        arr = np.asarray(_packed_or_repeated(g[7], None), np.int64)
    elif 5 in g:  # int32_data carries int32/int8/uint8/bool/fp16 payloads
        vals = np.asarray(_packed_or_repeated(g[5], None), np.int64)
        arr = vals.astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return TensorProto(name=name, array=arr.astype(np_dtype).reshape(dims))


def _parse_attr(buf: bytes) -> Attribute:
    g = _group(_fields(buf))
    a = Attribute(name=g.get(1, [b""])[0].decode())
    if 2 in g:
        a.f = struct.unpack("<f", g[2][0])[0]
    if 3 in g:
        a.i = _zigzag_i64(g[3][0])
    if 4 in g:
        a.s = g[4][0]
    if 5 in g:
        a.t = _parse_tensor(g[5][0])
    if 7 in g:
        a.floats = _packed_or_repeated(g[7], "f")
    if 8 in g:
        a.ints = _packed_or_repeated(g[8], None)
    return a


def _parse_node(buf: bytes) -> Node:
    g = _group(_fields(buf))
    attrs = [_parse_attr(b) for b in g.get(7, [])]
    return Node(
        op_type=g.get(4, [b""])[0].decode(),
        inputs=[b.decode() for b in g.get(1, [])],
        outputs=[b.decode() for b in g.get(2, [])],
        name=g.get(3, [b""])[0].decode(),
        attrs={a.name: a for a in attrs},
    )


def _parse_value_info(buf: bytes) -> ValueInfo:
    g = _group(_fields(buf))
    vi = ValueInfo(name=g.get(1, [b""])[0].decode())
    if 2 in g:  # TypeProto
        tg = _group(_fields(g[2][0]))
        if 1 in tg:  # tensor_type
            tt = _group(_fields(tg[1][0]))
            vi.elem_type = tt.get(1, [DT_FLOAT])[0]
            if 2 in tt:  # shape
                sg = _group(_fields(tt[2][0]))
                for dim_buf in sg.get(1, []):
                    dg = _group(_fields(dim_buf))
                    vi.shape.append(dg[1][0] if 1 in dg else -1)  # dim_param -> dynamic
    return vi


def _parse_graph(buf: bytes) -> Graph:
    g = _group(_fields(buf))
    inits = [_parse_tensor(b) for b in g.get(5, [])]
    return Graph(
        name=g.get(2, [b""])[0].decode(),
        nodes=[_parse_node(b) for b in g.get(1, [])],
        initializers={t.name: t.array for t in inits},
        inputs=[_parse_value_info(b) for b in g.get(11, [])],
        outputs=[_parse_value_info(b) for b in g.get(12, [])],
    )


def load_model(path: str) -> Graph:
    """Parse a model.onnx file into a Graph (≙ ORT session construction,
    reference model.cpp:825-870)."""
    with open(path, "rb") as f:
        buf = f.read()
    g = _group(_fields(buf))
    if 7 not in g:
        raise ValueError(f"{path}: no GraphProto in ModelProto (field 7)")
    return _parse_graph(g[7][0])


# ---------------------------------------------------------------- writing


def _w_varint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _w_key(field: int, wt: int) -> bytes:
    return _w_varint((field << 3) | wt)


def _w_len(field: int, payload: bytes) -> bytes:
    return _w_key(field, _LEN) + _w_varint(len(payload)) + payload


def _w_tensor(name: str, arr: np.ndarray) -> bytes:
    dt = _ONNX_FROM_NP.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    out = b"".join(_w_key(1, _VARINT) + _w_varint(d) for d in arr.shape)
    out += _w_key(2, _VARINT) + _w_varint(dt)
    out += _w_len(8, name.encode())
    out += _w_len(9, np.ascontiguousarray(arr).tobytes())
    return out


def _w_value_info(name: str, elem_type: int, shape) -> bytes:
    dims = b"".join(_w_len(1, _w_key(1, _VARINT) + _w_varint(d)) for d in shape)
    tensor_type = _w_key(1, _VARINT) + _w_varint(elem_type) + _w_len(2, dims)
    return _w_len(1, name.encode()) + _w_len(2, _w_len(1, tensor_type))


def _w_node(node: Node) -> bytes:
    out = b"".join(_w_len(1, s.encode()) for s in node.inputs)
    out += b"".join(_w_len(2, s.encode()) for s in node.outputs)
    if node.name:
        out += _w_len(3, node.name.encode())
    out += _w_len(4, node.op_type.encode())
    for a in node.attrs.values():
        ab = _w_len(1, a.name.encode())
        if a.f is not None:
            ab += _w_key(2, _I32) + struct.pack("<f", a.f)
        if a.i is not None:
            ab += _w_key(3, _VARINT) + _w_varint(a.i)
        if a.s is not None:
            ab += _w_len(4, a.s)
        for v in a.ints:
            ab += _w_key(8, _VARINT) + _w_varint(v)
        out += _w_len(7, ab)
    return out


def save_model(path: str, graph: Graph) -> None:
    """Serialize a Graph as a model.onnx file readable by onnxruntime (and
    by `load_model`)."""
    gb = b"".join(_w_len(1, _w_node(n)) for n in graph.nodes)
    gb += _w_len(2, graph.name.encode())
    gb += b"".join(_w_len(5, _w_tensor(k, v)) for k, v in graph.initializers.items())
    gb += b"".join(_w_len(11, _w_value_info(vi.name, vi.elem_type, vi.shape)) for vi in graph.inputs)
    gb += b"".join(_w_len(12, _w_value_info(vi.name, vi.elem_type, vi.shape)) for vi in graph.outputs)
    model = _w_key(1, _VARINT) + _w_varint(8)  # ir_version 8
    model += _w_len(7, gb)
    # opset_import { version: 13 }
    model += _w_len(8, _w_key(2, _VARINT) + _w_varint(13))
    with open(path, "wb") as f:
        f.write(model)
