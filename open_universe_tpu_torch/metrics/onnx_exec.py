"""In-house ONNX executor: protobuf wire-format parser + numpy interpreter
(the port's copy of the JAX package's ``metrics/onnx_exec.py``).

Exists so DNSMOS / PLCMOS (the reference's vendored Microsoft metric models,
its ``metrics/dnsmos/dnsmos_local.py:111`` and
``metrics/plcmos/plc_mos.py:59``) run in environments without ``onnxruntime``
— the official ``.onnx`` weights are plain protobuf files and their op
census is small (~26 ops incl. one GRU), so a numpy interpreter covers them
exactly.  ``OnnxSession`` mimics the small slice of the onnxruntime
``InferenceSession`` API the metric wrappers use (``run``, ``get_inputs``).

The parser is a hand-rolled protobuf *wire-format* walker (we have
``google.protobuf`` but not the ONNX descriptor set; the message schema
below is transcribed from onnx/onnx.proto field numbers).  Only the fields
the executor needs are decoded; unknown fields are skipped per protobuf
rules, so models with extra metadata parse fine.

Validated per op and end to end against ``torch.onnx.export``-minted
graphs.  What it does not implement fails loudly instead of computing
something else: ``auto_pad`` SAME_UPPER / SAME_LOWER on Conv and MaxPool,
integer Div (ONNX truncates, numpy's ``/`` would give floats) and a GRU with
``activations`` other than the default (Sigmoid, Tanh).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire-format primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a message buffer.

    wire 0 -> int varint; wire 1 -> 8 raw bytes; wire 2 -> memoryview;
    wire 5 -> 4 raw bytes.
    """
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _zigzag_signed(v: int) -> int:
    """Interpret a varint as a two's-complement int64 (protobuf int64)."""
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def _packed_varints(val, wtype) -> List[int]:
    """Repeated int64 field: either packed (wire 2) or one varint."""
    if wtype == 0:
        return [_zigzag_signed(val)]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(_zigzag_signed(v))
    return out


# ---------------------------------------------------------------------------
# ONNX message schema (field numbers from onnx/onnx.proto)
# ---------------------------------------------------------------------------

_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _parse_tensor(buf: memoryview) -> np.ndarray:
    dims: List[int] = []
    data_type = 1
    raw = b""
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    name = ""
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            dims.extend(_packed_varints(val, wtype))
        elif fnum == 2:
            data_type = val
        elif fnum == 4:  # float_data (packed wire 2 or repeated wire 5)
            if wtype == 5:
                float_data.append(np.frombuffer(val, "<f4")[0])
            else:
                float_data.extend(np.frombuffer(bytes(val), "<f4"))
        elif fnum == 5:
            int32_data.extend(_packed_varints(val, wtype))
        elif fnum == 7:
            int64_data.extend(_packed_varints(val, wtype))
        elif fnum == 8:
            name = bytes(val).decode("utf-8")
        elif fnum == 9:
            raw = bytes(val)
        elif fnum == 10:  # double_data
            if wtype == 1:
                double_data.append(np.frombuffer(val, "<f8")[0])
            else:
                double_data.extend(np.frombuffer(bytes(val), "<f8"))
    np_dtype = _DTYPES.get(data_type)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {data_type}")
    if raw:
        arr = np.frombuffer(raw, np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np_dtype)
    elif int64_data:
        arr = np.asarray(int64_data, np_dtype)
    elif int32_data:
        arr = np.asarray(int32_data, np_dtype)
    elif double_data:
        arr = np.asarray(double_data, np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    n = int(np.prod(dims)) if dims else arr.size
    if arr.size != n:
        # int32-backed types (bool/int8/...) are stored widened
        arr = arr[:n]
    return arr.reshape(dims).copy()


@dataclass
class Attribute:
    name: str
    value: Any


def _parse_attribute(buf: memoryview) -> Attribute:
    name = ""
    f = i = s = t = g = None
    atype = 0  # AttributeProto.type (field 20): proto3 omits zero values,
    #            so e.g. ``axis: 0`` serializes with ONLY the type field —
    #            the type enum supplies the default
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    have_repeated = False
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = bytes(val).decode("utf-8")
        elif fnum == 2:
            f = float(np.frombuffer(val, "<f4")[0])
        elif fnum == 3:
            i = _zigzag_signed(val)
        elif fnum == 4:
            s = bytes(val)
        elif fnum == 5:
            t = _parse_tensor(val)
        elif fnum == 6:
            g = _parse_graph(val)
        elif fnum == 7:
            have_repeated = True
            if wtype == 5:
                floats.append(float(np.frombuffer(val, "<f4")[0]))
            else:
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
        elif fnum == 8:
            have_repeated = True
            ints.extend(_packed_varints(val, wtype))
        elif fnum == 9:
            have_repeated = True
            strings.append(bytes(val))
        elif fnum == 20:
            atype = val
    for v in (t, g, s, i, f):
        if v is not None:
            return Attribute(name, v)
    if have_repeated:
        return Attribute(name, ints or floats or strings)
    # defaults by declared type: FLOAT=1 INT=2 STRING=3 FLOATS=6 INTS=7
    # STRINGS=8
    if atype == 1:
        return Attribute(name, 0.0)
    if atype == 2:
        return Attribute(name, 0)
    if atype == 3:
        return Attribute(name, b"")
    if atype in (6, 7, 8):
        return Attribute(name, [])
    return Attribute(name, None)


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]
    name: str = ""


def _parse_node(buf: memoryview) -> Node:
    inputs: List[str] = []
    outputs: List[str] = []
    op_type = ""
    name = ""
    attrs: Dict[str, Any] = {}
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            inputs.append(bytes(val).decode("utf-8"))
        elif fnum == 2:
            outputs.append(bytes(val).decode("utf-8"))
        elif fnum == 3:
            name = bytes(val).decode("utf-8")
        elif fnum == 4:
            op_type = bytes(val).decode("utf-8")
        elif fnum == 5:
            a = _parse_attribute(val)
            attrs[a.name] = a.value
    return Node(op_type, inputs, outputs, attrs, name)


def _parse_value_info(buf: memoryview) -> Tuple[str, Optional[List[Any]]]:
    """Return (name, shape) where shape entries are int or str (symbolic)."""
    name = ""
    shape: Optional[List[Any]] = None
    for fnum, _w, val in _iter_fields(buf):
        if fnum == 1:
            name = bytes(val).decode("utf-8")
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _iter_fields(v2):
                        if f3 == 2:  # TensorShapeProto
                            shape = []
                            for f4, _w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # dim
                                    dv: Any = None
                                    for f5, _w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dv = _zigzag_signed(v5)
                                        elif f5 == 2:
                                            dv = bytes(v5).decode("utf-8")
                                    shape.append(dv)
    return name, shape


@dataclass
class Graph:
    nodes: List[Node] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[Tuple[str, Optional[List[Any]]]] = field(default_factory=list)
    outputs: List[Tuple[str, Optional[List[Any]]]] = field(default_factory=list)
    name: str = ""


def _parse_graph(buf: memoryview) -> Graph:
    g = Graph()
    for fnum, _w, val in _iter_fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(val))
        elif fnum == 2:
            g.name = bytes(val).decode("utf-8")
        elif fnum == 5:
            t = _parse_tensor(val)
            # recover the tensor's name (parsed inside _parse_tensor but not
            # returned) — re-walk just for field 8
            tname = ""
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 8:
                    tname = bytes(v2).decode("utf-8")
            g.initializers[tname] = t
        elif fnum == 11:
            g.inputs.append(_parse_value_info(val))
        elif fnum == 12:
            g.outputs.append(_parse_value_info(val))
    return g


@dataclass
class Model:
    graph: Graph
    ir_version: int = 0
    opsets: Dict[str, int] = field(default_factory=dict)


def parse_model(data: bytes) -> Model:
    buf = memoryview(data)
    graph: Optional[Graph] = None
    ir_version = 0
    opsets: Dict[str, int] = {}
    for fnum, _w, val in _iter_fields(buf):
        if fnum == 1:
            ir_version = val
        elif fnum == 7:
            graph = _parse_graph(val)
        elif fnum == 8:  # OperatorSetIdProto
            dom, ver = "", 0
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:
                    dom = bytes(v2).decode("utf-8")
                elif f2 == 2:
                    ver = v2
            opsets[dom] = ver
    if graph is None:
        raise ValueError("no graph in model")
    return Model(graph, ir_version, opsets)


def load_model(path) -> Model:
    with open(path, "rb") as f:
        return parse_model(f.read())

# ---------------------------------------------------------------------------
# numpy/torch interpreter
# ---------------------------------------------------------------------------
#
# numpy implements the shape/elementwise/recurrent ops; Conv and MaxPool
# delegate to torch's CPU kernels (torch is an allowed dependency and these
# metrics are evaluation-only, exactly the role onnxruntime plays for the
# reference).  Opset semantics implemented: 10-13 era as used by the DNSMOS
# (opset 12) and PLCMOS (opset 11) graphs — Slice with tensor operands,
# Squeeze/Unsqueeze with the ``axes`` attribute, GRU with
# linear_before_reset.


def _attr(node: Node, name: str, default=None):
    v = node.attrs.get(name, default)
    if isinstance(v, bytes):
        return v.decode("utf-8")
    return v


def _auto_pad(node: Node) -> str:
    """NOTSET or VALID; SAME_* pads by the output shape, not implemented."""
    mode = _attr(node, "auto_pad", "NOTSET") or "NOTSET"
    if mode not in ("NOTSET", "VALID"):
        raise NotImplementedError(f"{node.op_type} auto_pad={mode}")
    return mode


def _op_conv(node: Node, x, w, b=None):
    import torch
    import torch.nn.functional as F

    spatial = x.ndim - 2
    pads = _attr(node, "pads", [0] * (2 * spatial))
    if _auto_pad(node) == "VALID":
        pads = [0] * (2 * spatial)
    strides = _attr(node, "strides", [1] * spatial)
    dilations = _attr(node, "dilations", [1] * spatial)
    group = int(_attr(node, "group", 1))
    begin, end = pads[:spatial], pads[spatial:]
    if begin != end:
        padw = [(0, 0), (0, 0)] + [(int(b_), int(e_))
                                   for b_, e_ in zip(begin, end)]
        x = np.pad(x, padw)
        begin = [0] * spatial
    xt = torch.from_numpy(np.ascontiguousarray(x))
    wt = torch.from_numpy(np.ascontiguousarray(w))
    bt = torch.from_numpy(np.ascontiguousarray(b)) if b is not None else None
    fn = F.conv1d if spatial == 1 else F.conv2d
    y = fn(xt, wt, bt, stride=tuple(int(s) for s in strides),
           padding=tuple(int(p) for p in begin),
           dilation=tuple(int(d) for d in dilations), groups=group)
    return y.numpy()


def _op_maxpool(node: Node, x):
    import torch
    import torch.nn.functional as F

    spatial = x.ndim - 2
    k = _attr(node, "kernel_shape")
    strides = _attr(node, "strides", k)
    pads = _attr(node, "pads", [0] * (2 * spatial))
    if _auto_pad(node) == "VALID":
        pads = [0] * (2 * spatial)
    ceil_mode = bool(_attr(node, "ceil_mode", 0))
    begin, end = pads[:spatial], pads[spatial:]
    if begin != end:
        raise NotImplementedError("asymmetric MaxPool pads")
    xt = torch.from_numpy(np.ascontiguousarray(x))
    fn = F.max_pool1d if spatial == 1 else F.max_pool2d
    y = fn(xt, kernel_size=tuple(int(v) for v in k),
           stride=tuple(int(s) for s in strides),
           padding=tuple(int(p) for p in begin), ceil_mode=ceil_mode)
    return y.numpy()


def _op_slice(vals):
    data, starts, ends = vals[0], vals[1], vals[2]
    axes = vals[3] if len(vals) > 3 and vals[3] is not None else \
        np.arange(len(starts))
    steps = vals[4] if len(vals) > 4 and vals[4] is not None else \
        np.ones(len(starts), np.int64)
    sl = [slice(None)] * data.ndim
    for s, e, a, st in zip(np.atleast_1d(starts), np.atleast_1d(ends),
                           np.atleast_1d(axes), np.atleast_1d(steps)):
        a = int(a) % data.ndim
        # ONNX clamps starts/ends to the valid range (INT64_MAX idiom)
        s, e, st = int(s), int(e), int(st)
        sl[a] = slice(s if s > -(1 << 62) else None,
                      e if abs(e) < (1 << 62) else None, st)
    return data[tuple(sl)]


def _op_gru(node: Node, vals):
    """ONNX GRU: gates ordered (z, r, h); returns (Y, Y_h).

    Y: (seq, num_directions, batch, hidden); Y_h: (num_dir, batch, hidden).
    Implements default sigmoid/tanh activations and both
    linear_before_reset modes; no sequence_lens support (the metric graphs
    pass '' there).
    """
    X, W, R = vals[0], vals[1], vals[2]
    H = int(_attr(node, "hidden_size"))
    nd = W.shape[0]
    B = vals[3] if len(vals) > 3 and vals[3] is not None else \
        np.zeros((nd, 6 * H), X.dtype)
    if len(vals) > 4 and vals[4] is not None and np.size(vals[4]):
        raise NotImplementedError("GRU sequence_lens")
    h0 = vals[5] if len(vals) > 5 and vals[5] is not None else \
        np.zeros((nd, X.shape[1], H), X.dtype)
    acts = [a.decode() if isinstance(a, bytes) else a
            for a in _attr(node, "activations", None) or []]
    if acts and [a.lower() for a in acts] != ["sigmoid", "tanh"] * (len(acts) // 2):
        raise NotImplementedError(f"GRU activations {acts}")
    lbr = int(_attr(node, "linear_before_reset", 0))
    direction = _attr(node, "direction", "forward")

    def run_dir(x_seq, w, r, b, h):
        wz, wr, wh = w[:H], w[H:2 * H], w[2 * H:]
        rz, rr, rh = r[:H], r[H:2 * H], r[2 * H:]
        wbz, wbr, wbh = b[:H], b[H:2 * H], b[2 * H:3 * H]
        rbz, rbr, rbh = b[3 * H:4 * H], b[4 * H:5 * H], b[5 * H:]
        ys = []
        for xt in x_seq:
            z = 1.0 / (1.0 + np.exp(-(xt @ wz.T + h @ rz.T + wbz + rbz)))
            rg = 1.0 / (1.0 + np.exp(-(xt @ wr.T + h @ rr.T + wbr + rbr)))
            if lbr:
                hh = np.tanh(xt @ wh.T + rg * (h @ rh.T + rbh) + wbh)
            else:
                hh = np.tanh(xt @ wh.T + (rg * h) @ rh.T + wbh + rbh)
            h = (1.0 - z) * hh + z * h
            ys.append(h)
        return np.stack(ys), h

    outs, hts = [], []
    for d in range(nd):
        rev = (direction == "reverse") or (d == 1)
        xs = X[::-1] if rev else X
        y, ht = run_dir(xs, W[d], R[d], B[d], h0[d])
        if rev:
            y = y[::-1]
        outs.append(y)
        hts.append(ht)
    Y = np.stack(outs, axis=1)  # (seq, num_dir, batch, H)
    return Y.astype(X.dtype), np.stack(hts).astype(X.dtype)


def _op_gemm(node: Node, vals):
    a, b = vals[0], vals[1]
    if int(_attr(node, "transA", 0)):
        a = a.T
    if int(_attr(node, "transB", 0)):
        b = b.T
    y = float(_attr(node, "alpha", 1.0)) * (a @ b)
    if len(vals) > 2 and vals[2] is not None:
        y = y + float(_attr(node, "beta", 1.0)) * vals[2]
    return y


def _op_reduce(node: Node, x, fn):
    axes = _attr(node, "axes", None)
    keep = bool(_attr(node, "keepdims", 1))
    ax = tuple(int(a) for a in axes) if axes else None
    return fn(x, axis=ax, keepdims=keep)


class _IOInfo:
    def __init__(self, name, shape):
        self.name = name
        self.shape = shape


class OnnxSession:
    """Drop-in for the slice of onnxruntime.InferenceSession the metric
    wrappers use: ``run(output_names, feed_dict)`` and ``get_inputs()``."""

    def __init__(self, model_path_or_bytes):
        if isinstance(model_path_or_bytes, (bytes, bytearray)):
            self.model = parse_model(bytes(model_path_or_bytes))
        else:
            self.model = load_model(model_path_or_bytes)
        g = self.model.graph
        init_names = set(g.initializers)
        self._inputs = [_IOInfo(n, s) for n, s in g.inputs
                        if n not in init_names]
        self._outputs = [_IOInfo(n, s) for n, s in g.outputs]

    def get_inputs(self):
        return self._inputs

    def get_outputs(self):
        return self._outputs

    def run(self, output_names, feed: Dict[str, np.ndarray]):
        g = self.model.graph
        env: Dict[str, np.ndarray] = dict(g.initializers)
        for k, v in feed.items():
            env[k] = np.asarray(v)
        for node in g.nodes:
            vals = [env[i] if i else None for i in node.inputs]
            op = node.op_type
            if op == "Conv":
                out = _op_conv(node, *vals)
            elif op == "MaxPool":
                out = _op_maxpool(node, vals[0])
            elif op == "Relu":
                out = np.maximum(vals[0], 0)
            elif op == "LeakyRelu":
                alpha = float(_attr(node, "alpha", 0.01))
                out = np.where(vals[0] >= 0, vals[0], alpha * vals[0])
            elif op == "Sigmoid":
                out = 1.0 / (1.0 + np.exp(-vals[0]))
            elif op == "MatMul":
                out = vals[0] @ vals[1]
            elif op == "Gemm":
                out = _op_gemm(node, vals)
            elif op == "GRU":
                out = _op_gru(node, vals)
            elif op == "Add":
                out = vals[0] + vals[1]
            elif op == "Mul":
                out = vals[0] * vals[1]
            elif op == "Div":
                if not (np.issubdtype(vals[0].dtype, np.floating)
                        and np.issubdtype(vals[1].dtype, np.floating)):
                    raise NotImplementedError(
                        f"integer Div ({vals[0].dtype} / {vals[1].dtype})")
                out = vals[0] / vals[1]
            elif op == "Sub":
                out = vals[0] - vals[1]
            elif op == "Sqrt":
                out = np.sqrt(vals[0])
            elif op == "Pow":
                out = np.power(vals[0], vals[1])
            elif op == "Log":
                out = np.log(vals[0])
            elif op == "Exp":
                out = np.exp(vals[0])
            elif op == "Tanh":
                out = np.tanh(vals[0])
            elif op == "Max":
                out = np.maximum(vals[0], vals[1])
            elif op == "Min":
                out = np.minimum(vals[0], vals[1])
            elif op == "ReduceMax":
                out = _op_reduce(node, vals[0], np.max)
            elif op == "ReduceMean":
                out = _op_reduce(node, vals[0], np.mean)
            elif op == "ReduceSum":
                out = _op_reduce(node, vals[0], np.sum)
            elif op == "Transpose":
                out = np.transpose(vals[0], _attr(node, "perm"))
            elif op == "Reshape":
                # ONNX: a 0 entry copies the corresponding input dim
                # (allowzero=0 default)
                shape = [vals[0].shape[i] if int(d) == 0 else int(d)
                         for i, d in enumerate(vals[1])]
                out = vals[0].reshape(shape)
            elif op == "Squeeze":
                axes = _attr(node, "axes", None)
                out = (np.squeeze(vals[0], tuple(int(a) for a in axes))
                       if axes else np.squeeze(vals[0]))
            elif op == "Unsqueeze":
                out = vals[0]
                for a in sorted(int(a) for a in _attr(node, "axes")):
                    out = np.expand_dims(out, a)
            elif op == "Slice":
                if len(node.inputs) == 1:  # opset<10: attribute form
                    starts = np.asarray(_attr(node, "starts"))
                    ends = np.asarray(_attr(node, "ends"))
                    axes = _attr(node, "axes", None)
                    vals = [vals[0], starts, ends,
                            np.asarray(axes) if axes else None]
                out = _op_slice(vals)
            elif op == "Concat":
                out = np.concatenate([v for v in vals],
                                     axis=int(_attr(node, "axis")))
            elif op == "Gather":
                out = np.take(vals[0], vals[1].astype(np.int64),
                              axis=int(_attr(node, "axis", 0)))
            elif op == "Shape":
                out = np.asarray(vals[0].shape, np.int64)
            elif op == "Constant":
                out = _attr(node, "value")
            elif op == "ConstantOfShape":
                v = _attr(node, "value")
                fill = v.reshape(-1)[0] if v is not None else np.float32(0)
                out = np.full([int(d) for d in vals[0]], fill,
                              dtype=v.dtype if v is not None else np.float32)
            elif op == "Expand":
                # bidirectional broadcast of data against the given shape
                tgt = [int(d) for d in vals[1]]
                out = np.broadcast_to(
                    vals[0], np.broadcast_shapes(vals[0].shape, tuple(tgt)))
            elif op == "Identity":
                out = vals[0]
            elif op == "Cast":
                out = vals[0].astype(_DTYPES[int(_attr(node, "to"))])
            elif op == "Flatten":
                ax = int(_attr(node, "axis", 1))
                out = vals[0].reshape(
                    int(np.prod(vals[0].shape[:ax], initial=1)), -1)
            else:
                raise NotImplementedError(f"ONNX op {op}")
            outs = out if isinstance(out, tuple) else (out,)
            for name, o in zip(node.outputs, outs):
                if name:
                    env[name] = np.asarray(o)
        names = output_names or [o.name for o in self._outputs]
        return [env[n] for n in names]
