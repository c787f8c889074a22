"""Minimal ONNX protobuf *encoder*.

Builds valid ONNX model files from scratch (same spirit as the reference's
``tests/fixtures/make_fixture_geomodel.py``, which commits a 264-byte
Gemm+Sigmoid graph with the real geomodel contract). Used by the test suite
to exercise the wire-format parser and the ONNX->JAX lowering without the
``onnx`` package or network access, and by :mod:`.fullscale` to synthesize
real-dimension classifier graphs for parity verification and benchmarking.
"""

from __future__ import annotations

import struct

import numpy as np

DT = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.int32): 6, np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
    np.dtype(np.float16): 10, np.dtype(np.float64): 11,
}


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wtype: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wtype) + payload


def _msg(num: int, body: bytes) -> bytes:
    return _field(num, 2, _varint(len(body)) + body)


def _str(num: int, s: str) -> bytes:
    b = s.encode()
    return _field(num, 2, _varint(len(b)) + b)


def _int(num: int, v: int) -> bytes:
    return _field(num, 0, _varint(v & ((1 << 64) - 1)))


def _float(num: int, v: float) -> bytes:
    return _field(num, 5, struct.pack("<f", v))


def tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    shape = arr.shape  # ascontiguousarray promotes 0-d to 1-d; keep the truth
    arr = np.ascontiguousarray(arr)
    body = b""
    for d in shape:
        body += _int(1, d)
    body += _int(2, DT[arr.dtype])
    body += _str(8, name)
    body += _msg(9, arr.tobytes())  # raw_data
    return body


def external_tensor(name: str, arr: np.ndarray, location: str,
                    offset: int = 0, length: int | None = None,
                    with_length: bool = True) -> bytes:
    """TensorProto with ``data_location = EXTERNAL``: dims/dtype inline,
    payload expected at ``offset`` (+``length``) inside the sidecar file
    ``location`` (the onnx ``convert_model_to_external_data`` layout).
    Returns the proto bytes only — writing the sidecar is the caller's job.
    """
    arr = np.ascontiguousarray(np.asarray(arr))
    body = b""
    for d in arr.shape:
        body += _int(1, d)
    body += _int(2, DT[arr.dtype])
    body += _str(8, name)
    entries = [("location", location), ("offset", str(offset))]
    if with_length:
        entries.append(
            ("length", str(arr.nbytes if length is None else length))
        )
    for k, v in entries:
        body += _msg(13, _str(1, k) + _str(2, v))
    body += _int(14, 1)  # data_location = EXTERNAL
    return body


def attr_int(name: str, v: int) -> bytes:
    return _str(1, name) + _int(3, v) + _int(20, 2)


def attr_float(name: str, v: float) -> bytes:
    return _str(1, name) + _float(2, v) + _int(20, 1)


def attr_ints(name: str, vs) -> bytes:
    body = _str(1, name)
    for v in vs:
        body += _int(8, v)
    return body + _int(20, 7)


def attr_str(name: str, s: str) -> bytes:
    b = s.encode()
    return _str(1, name) + _field(4, 2, _varint(len(b)) + b) + _int(20, 3)


def attr_tensor(name: str, arr: np.ndarray) -> bytes:
    return _str(1, name) + _msg(5, tensor("", arr)) + _int(20, 4)


def graph(nodes, inputs, outputs, initializers=(), graph_name="sub") -> bytes:
    """Bare GraphProto bytes (for subgraph attributes)."""
    g = b""
    for n in nodes:
        g += _msg(1, n)
    g += _str(2, graph_name)
    for t in initializers:
        g += _msg(5, t)
    for vi in inputs:
        g += _msg(11, vi)
    for vi in outputs:
        g += _msg(12, vi)
    return g


def attr_graph(name: str, graph_bytes: bytes) -> bytes:
    """Subgraph attribute (If branches, Loop/Scan bodies)."""
    return _str(1, name) + _msg(6, graph_bytes) + _int(20, 5)


def attr_ref(name: str, ref_name: str) -> bytes:
    """An attribute that references a function-call attribute
    (``ref_attr_name`` — only meaningful inside FunctionProto bodies)."""
    return _str(1, name) + _str(21, ref_name)


def node(op_type: str, inputs, outputs, name="", attrs=(), domain="") -> bytes:
    body = b""
    for i in inputs:
        body += _str(1, i)
    for o in outputs:
        body += _str(2, o)
    body += _str(3, name or op_type)
    body += _str(4, op_type)
    for a in attrs:
        body += _msg(5, a)
    if domain:
        body += _str(7, domain)
    return body


def function(name: str, inputs, outputs, nodes, domain="local",
             attr_names=(), attr_defaults=()) -> bytes:
    """FunctionProto bytes (model-local function definition)."""
    body = _str(1, name)
    for i in inputs:
        body += _str(4, i)
    for o in outputs:
        body += _str(5, o)
    for a in attr_names:
        body += _str(6, a)
    for n in nodes:
        body += _msg(7, n)
    body += _str(10, domain)
    for a in attr_defaults:
        body += _msg(11, a)
    return body


def value_info(name: str, shape, elem_type=1) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dim = _str(2, d)
        else:
            dim = _int(1, d)
        dims += _msg(1, dim)
    shape_msg = _msg(2, dims)
    ttype = _msg(1, _int(1, elem_type) + shape_msg)
    return _str(1, name) + _msg(2, ttype)


def model(nodes, inputs, outputs, initializers=(), opset=13, graph_name="g",
          functions=()) -> bytes:
    g = b""
    for n in nodes:
        g += _msg(1, n)
    g += _str(2, graph_name)
    for t in initializers:
        g += _msg(5, t)
    for vi in inputs:
        g += _msg(11, vi)
    for vi in outputs:
        g += _msg(12, vi)
    opset_msg = _str(1, "") + _int(2, opset)
    out = _int(1, 8) + _msg(7, g) + _msg(8, opset_msg)
    for f in functions:
        out += _msg(25, f)
    return out


def make_fixture_geomodel(num_species: int = 64, seed: int = 42) -> bytes:
    """Gemm+Sigmoid graph with the real geomodel I/O contract:
    [batch,3] float32 -> [batch,N] sigmoid scores. Weights chosen so a
    mid-latitude query spreads scores across the 0.01-0.1 threshold band."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.8, (3, num_species)).astype(np.float32)
    b = rng.normal(-2.0, 1.5, num_species).astype(np.float32)
    nodes = [
        node("Gemm", ["input", "W", "B"], ["logits"], "gemm"),
        node("Sigmoid", ["logits"], ["output"], "sig"),
    ]
    return model(
        nodes,
        inputs=[value_info("input", ["batch", 3])],
        outputs=[value_info("output", ["batch", num_species])],
        initializers=[tensor("W", w), tensor("B", b)],
    )
