"""Minimal ONNX protobuf reader (wire format, no ``onnx`` dependency).

The reference executes ONNX graphs through ONNX Runtime's C++ library
(reference ``src/inference/runtime.rs:14-120``). The TPU-native equivalent
lowers the same graphs to XLA: this module parses the ONNX protobuf wire
format into light Python structures, and :mod:`birda_tpu.onnx.lowering`
translates the graph to a jax function.

Only the message fields the five birda model families use are decoded;
unknown fields are skipped per protobuf rules, so richer models still parse.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# ONNX TensorProto.DataType values.
DT_FLOAT = 1
DT_UINT8 = 2
DT_INT8 = 3
DT_UINT16 = 4
DT_INT16 = 5
DT_INT32 = 6
DT_INT64 = 7
DT_STRING = 8
DT_BOOL = 9
DT_FLOAT16 = 10
DT_DOUBLE = 11
DT_UINT32 = 12
DT_UINT64 = 13

_NP_DTYPES = {
    DT_FLOAT: np.float32,
    DT_UINT8: np.uint8,
    DT_INT8: np.int8,
    DT_UINT16: np.uint16,
    DT_INT16: np.int16,
    DT_INT32: np.int32,
    DT_INT64: np.int64,
    DT_BOOL: np.bool_,
    DT_FLOAT16: np.float16,
    DT_DOUBLE: np.float64,
    DT_UINT32: np.uint32,
    DT_UINT64: np.uint64,
}


class WireError(ValueError):
    pass


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise WireError("varint too long")


def _scan(buf: memoryview):
    """Yield (field_number, wire_type, value) for every field in a message.

    wire_type 0 -> int, 1 -> 8 bytes, 2 -> memoryview, 5 -> 4 bytes.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 0x7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wtype == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wtype == 5:
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise WireError(f"unsupported wire type {wtype}")
        if pos > n:
            raise WireError("field overruns message")
        yield fnum, wtype, val


def _signed(v: int) -> int:
    """Interpret a varint as a two's-complement int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# Decoded structures
# ---------------------------------------------------------------------------

#: TensorProto.DataLocation values.
LOCATION_DEFAULT = 0
LOCATION_EXTERNAL = 1


@dataclass
class Tensor:
    name: str = ""
    dims: tuple[int, ...] = ()
    data_type: int = DT_FLOAT
    array: np.ndarray | None = None
    #: TensorProto.data_location (LOCATION_EXTERNAL = payload lives in a
    #: sidecar file; real 400-560 MB exports routinely ship this way).
    data_location: int = LOCATION_DEFAULT
    #: TensorProto.external_data key/value entries ("location", "offset",
    #: "length", "checksum").
    external_data: dict[str, str] = field(default_factory=dict)


@dataclass
class Attribute:
    name: str = ""
    f: float | None = None
    i: int | None = None
    s: bytes | None = None
    t: Tensor | None = None
    #: Subgraph attribute (If branches, Loop/Scan bodies). Typed ``object``
    #: because :class:`Graph` is declared later in this module.
    g: object | None = None
    #: Set when this attribute is a reference to a function-call attribute
    #: (FunctionProto bodies); resolved during function inlining.
    ref_attr_name: str = ""
    floats: list[float] = field(default_factory=list)
    ints: list[int] = field(default_factory=list)
    strings: list[bytes] = field(default_factory=list)

    @property
    def value(self):
        for v in (self.i, self.f, self.s, self.t, self.g):
            if v is not None:
                return v
        for v in (self.ints, self.floats, self.strings):
            if v:
                return v
        return None


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    #: Operator domain ("" / "ai.onnx" = standard; model-local functions
    #: live in custom domains).
    domain: str = ""
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)
    attrs: dict[str, Attribute] = field(default_factory=dict)

    def attr(self, name: str, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = DT_FLOAT
    #: Shape dims: int for fixed, str for symbolic (e.g. "batch"), None unknown.
    shape: list[int | str | None] = field(default_factory=list)


@dataclass
class Graph:
    name: str = ""
    nodes: list[Node] = field(default_factory=list)
    initializers: dict[str, Tensor] = field(default_factory=dict)
    inputs: list[ValueInfo] = field(default_factory=list)
    outputs: list[ValueInfo] = field(default_factory=list)


@dataclass
class Function:
    """A model-local function (FunctionProto): a reusable subgraph keyed by
    (domain, name), called by nodes whose op_type names it. Inlined at load
    (``_inline_functions``) so the lowering only ever sees standard ops."""

    name: str = ""
    domain: str = ""
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)
    #: Declared attribute parameter names (callers may set them).
    attr_names: list[str] = field(default_factory=list)
    #: Default values for attribute parameters (attribute_proto entries).
    attr_defaults: dict[str, Attribute] = field(default_factory=dict)
    nodes: list[Node] = field(default_factory=list)


@dataclass
class Model:
    ir_version: int = 0
    opset: int = 0
    graph: Graph = field(default_factory=Graph)
    #: Model-local functions by (domain, name); consumed (inlined) at load.
    functions: dict = field(default_factory=dict)


def constant_payload(node: Node):
    """The array a ``Constant`` node carries, across its attribute
    spellings: ``value`` (tensor) plus the opset-12 scalar/list forms
    ``value_float/value_int/value_floats/value_ints``. Returns None when
    the node uses a spelling we cannot fold (``sparse_value``, strings) —
    preflight reports those as findings."""
    t = node.attr("value")
    if t is not None and getattr(t, "array", None) is not None:
        return t.array
    v = node.attr("value_float")
    if v is not None:
        return np.float32(v)
    v = node.attr("value_int")
    if v is not None:
        return np.int64(v)
    v = node.attr("value_floats")
    if v is not None:
        return np.asarray(list(v), np.float32)
    v = node.attr("value_ints")
    if v is not None:
        return np.asarray(list(v), np.int64)
    return None


# ---------------------------------------------------------------------------
# Message decoders
# ---------------------------------------------------------------------------

def _decode_tensor(buf: memoryview) -> Tensor:
    t = Tensor()
    dims: list[int] = []
    float_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    double_data: list[float] = []
    raw: bytes | None = None
    for fnum, wtype, val in _scan(buf):
        if fnum == 1 and wtype == 0:
            dims.append(_signed(val))
        elif fnum == 1 and wtype == 2:  # packed dims
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                dims.append(_signed(v))
        elif fnum == 2 and wtype == 0:
            t.data_type = val
        elif fnum == 4:
            if wtype == 2:  # packed floats
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", bytes(val))
                )
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif fnum == 5:
            if wtype == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int32_data.append(_signed(v))
            else:
                int32_data.append(_signed(val))
        elif fnum == 7:
            if wtype == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64_data.append(_signed(v))
            else:
                int64_data.append(_signed(val))
        elif fnum == 8 and wtype == 2:
            t.name = bytes(val).decode("utf-8", "replace")
        elif fnum == 9 and wtype == 2:
            raw = bytes(val)
        elif fnum == 10:
            if wtype == 2:
                double_data.extend(
                    struct.unpack(f"<{len(val) // 8}d", bytes(val))
                )
            else:
                double_data.append(struct.unpack("<d", val)[0])
        elif fnum == 13 and wtype == 2:  # external_data StringStringEntry
            key = value = ""
            for f2, w2, v2 in _scan(val):
                if f2 == 1 and w2 == 2:
                    key = bytes(v2).decode("utf-8", "replace")
                elif f2 == 2 and w2 == 2:
                    value = bytes(v2).decode("utf-8", "replace")
            if key:
                t.external_data[key] = value
        elif fnum == 14 and wtype == 0:
            t.data_location = val

    t.dims = tuple(dims)
    if t.data_location == LOCATION_EXTERNAL:
        # Payload lives in a sidecar file; resolved by load_model once the
        # model's base directory is known. array stays None until then.
        return t
    np_dtype = _NP_DTYPES.get(t.data_type)
    if np_dtype is None:
        return t  # leave array None for exotic types

    if raw is not None:
        arr = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder("<"))
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif double_data:
        arr = np.asarray(double_data, np.float64)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    elif int32_data:
        # int32_data also carries bool/int8/int16/float16 payloads
        arr = np.asarray(int32_data, np.int32)
        if t.data_type == DT_FLOAT16:
            arr = arr.astype(np.uint16).view(np.float16)
    else:
        arr = np.zeros(0, np_dtype)

    if t.data_type in _NP_DTYPES and arr.dtype != np_dtype:
        arr = arr.astype(np_dtype)
    try:
        t.array = arr.reshape(t.dims) if t.dims else arr.reshape(())
    except ValueError:
        raise WireError(
            f"tensor '{t.name}' payload of {arr.size} elements does not "
            f"match dims {t.dims}"
        ) from None
    return t


def _dec_str(val) -> str:
    try:
        return bytes(val).decode()
    except UnicodeDecodeError as e:
        raise WireError(f"invalid UTF-8 string field: {e}") from None


def _decode_attribute(buf: memoryview) -> Attribute:
    a = Attribute()
    for fnum, wtype, val in _scan(buf):
        if fnum == 1 and wtype == 2:
            a.name = _dec_str(val)
        elif fnum == 2 and wtype == 5:
            a.f = struct.unpack("<f", val)[0]
        elif fnum == 3 and wtype == 0:
            a.i = _signed(val)
        elif fnum == 4 and wtype == 2:
            a.s = bytes(val)
        elif fnum == 5 and wtype == 2:
            a.t = _decode_tensor(val)
        elif fnum == 6 and wtype == 2:  # subgraph (If/Loop/Scan bodies)
            a.g = _decode_graph(val)
        elif fnum == 21 and wtype == 2:  # ref_attr_name (function bodies)
            a.ref_attr_name = _dec_str(val)
        elif fnum == 7:
            if wtype == 2:
                a.floats.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
            else:
                a.floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            if wtype == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    a.ints.append(_signed(v))
            else:
                a.ints.append(_signed(val))
        elif fnum == 9 and wtype == 2:
            a.strings.append(bytes(val))
    return a


def _decode_node(buf: memoryview) -> Node:
    n = Node()
    for fnum, wtype, val in _scan(buf):
        if fnum == 1 and wtype == 2:
            n.inputs.append(_dec_str(val))
        elif fnum == 2 and wtype == 2:
            n.outputs.append(_dec_str(val))
        elif fnum == 3 and wtype == 2:
            n.name = _dec_str(val)
        elif fnum == 4 and wtype == 2:
            n.op_type = _dec_str(val)
        elif fnum == 5 and wtype == 2:
            a = _decode_attribute(val)
            n.attrs[a.name] = a
        elif fnum == 7 and wtype == 2:
            n.domain = _dec_str(val)
    return n


def _decode_value_info(buf: memoryview) -> ValueInfo:
    vi = ValueInfo()
    for fnum, wtype, val in _scan(buf):
        if fnum == 1 and wtype == 2:
            vi.name = _dec_str(val)
        elif fnum == 2 and wtype == 2:  # TypeProto
            for f2, w2, v2 in _scan(val):
                if f2 == 1 and w2 == 2:  # tensor_type
                    for f3, w3, v3 in _scan(v2):
                        if f3 == 1 and w3 == 0:
                            vi.elem_type = v3
                        elif f3 == 2 and w3 == 2:  # shape
                            for f4, w4, v4 in _scan(v3):
                                if f4 == 1 and w4 == 2:  # dim
                                    dim: int | str | None = None
                                    for f5, w5, v5 in _scan(v4):
                                        if f5 == 1 and w5 == 0:
                                            dim = _signed(v5)
                                        elif f5 == 2 and w5 == 2:
                                            dim = bytes(v5).decode()
                                    vi.shape.append(dim)
    return vi


def _decode_graph(buf: memoryview) -> Graph:
    g = Graph()
    for fnum, wtype, val in _scan(buf):
        if fnum == 1 and wtype == 2:
            g.nodes.append(_decode_node(val))
        elif fnum == 2 and wtype == 2:
            g.name = _dec_str(val)
        elif fnum == 5 and wtype == 2:
            t = _decode_tensor(val)
            g.initializers[t.name] = t
        elif fnum == 11 and wtype == 2:
            g.inputs.append(_decode_value_info(val))
        elif fnum == 12 and wtype == 2:
            g.outputs.append(_decode_value_info(val))
    return g


def _decode_function(buf: memoryview) -> Function:
    f = Function()
    for fnum, wtype, val in _scan(buf):
        if fnum == 1 and wtype == 2:
            f.name = _dec_str(val)
        elif fnum == 4 and wtype == 2:
            f.inputs.append(_dec_str(val))
        elif fnum == 5 and wtype == 2:
            f.outputs.append(_dec_str(val))
        elif fnum == 6 and wtype == 2:
            f.attr_names.append(_dec_str(val))
        elif fnum == 7 and wtype == 2:
            f.nodes.append(_decode_node(val))
        elif fnum == 10 and wtype == 2:
            f.domain = _dec_str(val)
        elif fnum == 11 and wtype == 2:
            a = _decode_attribute(val)
            f.attr_defaults[a.name] = a
    return f


def _instantiate_function(f: Function, node: Node, uid: int) -> list[Node]:
    """Clone a function body for one call site: formal inputs/outputs map
    to the node's actual names, every internal name gets a per-call prefix
    (alpha-renaming), and ref_attr_name attributes resolve to the call
    site's attribute (or the function's declared default)."""
    import dataclasses

    prefix = f"{node.name or f.name}__f{uid}/"
    mapping: dict[str, str] = {}
    for formal, actual in zip(f.inputs, node.inputs):
        mapping[formal] = actual
    for formal in f.inputs[len(node.inputs):]:
        mapping[formal] = ""  # optional input left absent at the call site
    for formal, actual in zip(f.outputs, node.outputs):
        # An omitted ("") call-site output stays an internal name: body
        # nodes may still consume the formal as an intermediate.
        if actual:
            mapping[formal] = actual

    def ren(n: str) -> str:
        if not n:
            return ""
        return mapping.get(n, prefix + n)

    def clone_graph(g: Graph) -> Graph:
        ng = Graph(name=g.name)
        ng.initializers = {ren(k): t for k, t in g.initializers.items()}
        ng.inputs = [dataclasses.replace(vi, name=ren(vi.name))
                     for vi in g.inputs]
        ng.outputs = [dataclasses.replace(vi, name=ren(vi.name))
                      for vi in g.outputs]
        ng.nodes = [clone_node(bn) for bn in g.nodes]
        return ng

    def clone_node(bn: Node) -> Node:
        nn = Node(op_type=bn.op_type, name=prefix + (bn.name or bn.op_type),
                  domain=bn.domain,
                  inputs=[ren(i) for i in bn.inputs],
                  outputs=[ren(o) for o in bn.outputs])
        for aname, a in bn.attrs.items():
            if a.ref_attr_name:
                site = node.attrs.get(a.ref_attr_name)
                if site is None:
                    site = f.attr_defaults.get(a.ref_attr_name)
                if site is not None:
                    nn.attrs[aname] = dataclasses.replace(site, name=aname)
                # Unset and no default: the attribute stays absent and the
                # op handler's own default applies (spec behavior).
            elif a.g is not None:
                nn.attrs[aname] = dataclasses.replace(a, g=clone_graph(a.g))
            else:
                nn.attrs[aname] = a
        return nn

    return [clone_node(bn) for bn in f.nodes]


def _inline_functions(graph: Graph, funcs: dict) -> None:
    """Replace every call to a model-local function with its instantiated
    body, repeating until none remain (functions may call functions)."""
    if not funcs:
        return
    uid = 0
    for _ in range(16):
        changed = False
        new_nodes: list[Node] = []
        for node in graph.nodes:
            f = funcs.get((node.domain, node.op_type))
            if f is None:
                for a in node.attrs.values():
                    if a.g is not None:
                        _inline_functions(a.g, funcs)
                new_nodes.append(node)
                continue
            uid += 1
            new_nodes.extend(_instantiate_function(f, node, uid))
            changed = True
        graph.nodes = new_nodes
        if not changed:
            return
    raise WireError(
        "function inlining did not converge after 16 passes "
        "(mutually recursive model-local functions?)")


def _external_tensors(graph: Graph):
    """Yield every tensor in the graph whose payload is external: the
    initializers plus Constant-node attribute tensors."""
    for t in graph.initializers.values():
        if t.data_location == LOCATION_EXTERNAL:
            yield t
    for node in graph.nodes:
        for a in node.attrs.values():
            if a.t is not None and a.t.data_location == LOCATION_EXTERNAL:
                yield a.t
            if a.g is not None:
                yield from _external_tensors(a.g)


def _resolve_external_data(graph: Graph, base_dir: Path | None) -> None:
    """Load ``data_location = EXTERNAL`` tensor payloads from their sidecar
    files (the onnx ``convert_model_to_external_data`` layout: little-endian
    raw bytes at ``offset``/``length`` inside ``location``, relative to the
    model file's directory). Typed ``OnnxExternalData`` errors when the
    sidecar is absent, escapes the model directory, or is too short —
    ORT handles these files natively (reference
    ``src/inference/runtime.rs:14``), so day-one real-asset loading must
    not brick on them.
    """
    from ..errors import OnnxExternalData

    tensors = list(_external_tensors(graph))
    if not tensors:
        return
    if base_dir is None:
        raise OnnxExternalData(
            tensors[0].name or "<unnamed>",
            "the graph references external weight files, but it was loaded "
            "from raw bytes with no base directory to resolve them against",
        )
    base_dir = Path(base_dir).resolve()
    for t in tensors:
        tname = t.name or "<unnamed>"
        loc = t.external_data.get("location")
        if not loc:
            raise OnnxExternalData(tname, "external_data has no 'location'")
        sidecar = (base_dir / loc).resolve()
        if base_dir not in sidecar.parents and sidecar != base_dir:
            raise OnnxExternalData(
                tname, f"location '{loc}' escapes the model directory"
            )
        if not sidecar.is_file():
            raise OnnxExternalData(
                tname,
                f"sidecar file '{loc}' not found next to the model — "
                "external-data exports must be copied with their weight "
                "files",
            )
        try:
            offset = int(t.external_data.get("offset", 0))
            length = t.external_data.get("length")
            length = None if length is None else int(length)
        except ValueError as e:
            raise OnnxExternalData(tname, f"bad offset/length: {e}") from e
        np_dtype = _NP_DTYPES.get(t.data_type)
        if np_dtype is None:
            continue  # exotic dtype: leave array None (preflight reports it)
        count = int(np.prod(t.dims, dtype=np.int64)) if t.dims else 1
        need = count * np.dtype(np_dtype).itemsize
        if length is not None and length < need:
            raise OnnxExternalData(
                tname, f"length {length} < {need} bytes required by "
                f"dims {t.dims}"
            )
        file_size = sidecar.stat().st_size
        if offset + need > file_size:
            raise OnnxExternalData(
                tname,
                f"'{loc}' is {file_size} bytes; tensor needs bytes "
                f"[{offset}, {offset + need})",
            )
        with open(sidecar, "rb") as f:
            f.seek(offset)
            raw = f.read(need)
        arr = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder("<"))
        if arr.dtype != np_dtype:
            arr = arr.astype(np_dtype)
        t.array = arr.reshape(t.dims) if t.dims else arr.reshape(())
        t.data_location = LOCATION_DEFAULT


def load_model(path: Path | str | bytes,
               base_dir: Path | str | None = None) -> Model:
    """Parse an ONNX file (or raw bytes) into a :class:`Model`.

    ``base_dir`` resolves ``data_location = EXTERNAL`` tensor sidecars;
    it defaults to the model file's directory when ``path`` is a path.
    """
    if isinstance(path, bytes):
        data = path
    else:
        data = Path(path).read_bytes()
        if base_dir is None:
            base_dir = Path(path).parent
    m = Model()
    try:
        for fnum, wtype, val in _scan(memoryview(data)):
            if fnum == 1 and wtype == 0:
                m.ir_version = val
            elif fnum == 7 and wtype == 2:
                m.graph = _decode_graph(val)
            elif fnum == 8 and wtype == 2:  # opset_import
                # Only the DEFAULT domain's version is the model opset: a
                # com.microsoft/custom-domain entry (field 1 = domain)
                # carries its own versioning and must not inflate
                # opset-gated decisions in the lowering.
                domain = b""
                version = 0
                for f2, w2, v2 in _scan(val):
                    if f2 == 1 and w2 == 2:
                        domain = bytes(v2)
                    elif f2 == 2 and w2 == 0:
                        version = v2
                if domain in (b"", b"ai.onnx"):
                    m.opset = max(m.opset, version)
            elif fnum == 25 and wtype == 2:  # model-local functions
                func = _decode_function(val)
                m.functions[(func.domain, func.name)] = func
    except WireError:
        raise
    except Exception as e:
        # Corrupted bytes can trip decoders in arbitrary ways (misaligned
        # packed fields, wrong wire types on known fields); every parse
        # failure must be the one typed error (fuzz-pinned).
        raise WireError(
            f"malformed model protobuf: {type(e).__name__}: {e}"
        ) from e
    _inline_functions(m.graph, m.functions)
    _resolve_external_data(
        m.graph, None if base_dir is None else Path(base_dir)
    )
    return m
