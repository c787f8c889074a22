"""Whole-graph supportability preflight for ONNX models.

When the lowering meets an unsupported op it can only raise on the *first*
one; a real-asset encounter then becomes a fix-one-retry loop. This module
walks the entire graph up front and reports **every** unsupported op,
attribute configuration, and dtype in one pass, so day one with a new
export yields a single actionable fix list (the reference surfaces ~90
actionable error variants the same way, ``src/error.rs:8``; ORT itself
validates the whole graph at session build, ``src/inference/runtime.rs:14``).

Used three ways:

- :func:`preflight` returns the findings (``models check`` renders them);
- :func:`preflight_or_raise` raises one :class:`~birda_tpu.errors.OnnxGraphUnsupported`
  listing all of them (called by the lowering before execution);
- the findings format is stable enough to golden-pin in tests.
"""

from __future__ import annotations

from dataclasses import dataclass

from .proto import LOCATION_EXTERNAL, _NP_DTYPES, Model, load_model

#: Readable names for ONNX TensorProto.DataType values we may reject.
_DT_NAMES = {
    0: "UNDEFINED", 1: "FLOAT", 2: "UINT8", 3: "INT8", 4: "UINT16",
    5: "INT16", 6: "INT32", 7: "INT64", 8: "STRING", 9: "BOOL",
    10: "FLOAT16", 11: "DOUBLE", 12: "UINT32", 13: "UINT64",
    14: "COMPLEX64", 15: "COMPLEX128", 16: "BFLOAT16",
    17: "FLOAT8E4M3FN", 18: "FLOAT8E4M3FNUZ", 19: "FLOAT8E5M2",
    20: "FLOAT8E5M2FNUZ", 21: "UINT4", 22: "INT4", 23: "FLOAT4E2M1",
}


@dataclass(frozen=True)
class Finding:
    """One preflight issue: where it is, what it is, why it blocks."""

    node: str       #: node or tensor name ("" when the graph omits names)
    op_type: str    #: op type, or "<initializer>" / "<input>"
    reason: str

    def render(self) -> str:
        where = f" (node '{self.node}')" if self.node else ""
        return f"{self.op_type}{where}: {self.reason}"


def _attr_findings(node, opset: int = 0) -> list[str]:
    """Statically-checkable attribute limits of otherwise-supported ops.

    Conservative: only configurations the evaluator is *certain* to reject
    are flagged (attributes are static in the wire format; input-dependent
    limits are left to runtime). ``tests/test_preflight_property.py`` pins
    the invariant both ways: preflight-clean grids must execute without an
    ``UnsupportedOnnxOp``, and every static runtime raise must have a rule
    here.
    """
    reasons = []
    op = node.op_type
    if op == "CumSum":
        if node.attr("exclusive", 0) or node.attr("reverse", 0):
            reasons.append("exclusive/reverse CumSum is not supported")
    elif op == "TopK":
        if not node.attr("largest", 1):
            reasons.append("TopK with largest=0 is not supported")
    elif op == "Resize":
        mode = node.attr("mode", b"nearest")
        if isinstance(mode, bytes):
            mode = mode.decode()
        if mode not in ("nearest", "linear", "cubic"):
            reasons.append(f"Resize mode '{mode}' is not supported")
        ct = node.attr("coordinate_transformation_mode", b"half_pixel")
        if isinstance(ct, bytes):
            ct = ct.decode()
        supported_ct = ("half_pixel", "pytorch_half_pixel", "asymmetric",
                        "align_corners", "tf_half_pixel_for_nn")
        if ct not in supported_ct:
            reasons.append(
                f"Resize coordinate_transformation_mode '{ct}' "
                "is not supported")
        elif mode == "cubic" and ct != "half_pixel":
            reasons.append(
                f"Resize cubic supports only half_pixel coordinates "
                f"(got '{ct}')")
        nm = node.attr("nearest_mode", b"round_prefer_floor")
        if isinstance(nm, bytes):
            nm = nm.decode()
        if mode == "nearest" and nm not in (
                "round_prefer_floor", "round_prefer_ceil", "floor", "ceil"):
            reasons.append(f"Resize nearest_mode '{nm}' is not supported")
        if node.attr("antialias", 0):
            reasons.append("Resize antialias=1 is not supported")
        if node.attr("exclude_outside", 0):
            reasons.append("Resize exclude_outside=1 is not supported")
        kap = node.attr("keep_aspect_ratio_policy", b"stretch")
        if isinstance(kap, bytes):
            kap = kap.decode()
        if kap != "stretch":
            reasons.append(
                f"Resize keep_aspect_ratio_policy '{kap}' is not supported")
    elif op == "MaxPool":
        if sum(1 for o in node.outputs if o) > 1:
            reasons.append("MaxPool with an Indices output is not supported")
    elif op == "DFT":
        if node.attr("inverse", 0):
            reasons.append("inverse DFT is not supported")
    elif op in ("ArgMax", "ArgMin"):
        if node.attr("select_last_index", 0):
            reasons.append(f"{op} with select_last_index=1 is not supported")
    elif op == "Pad":
        mode = node.attr("mode", b"constant")
        if isinstance(mode, bytes):
            mode = mode.decode()
        if mode not in ("constant", "reflect", "edge", "wrap"):
            reasons.append(f"Pad mode '{mode}' is not supported")
    elif op == "Cast":
        to = node.attr("to")
        if to not in _NP_DTYPES:
            reasons.append(
                f"Cast to {_DT_NAMES.get(to, to)} is not supported"
            )
    elif op == "Attention":
        if any(node.inputs[i] for i in (4, 5) if len(node.inputs) > i):
            reasons.append(
                "Attention past_key/past_value (KV cache) inputs are "
                "not supported")
        if (len(node.outputs) > 3 and node.outputs[3]
                and node.attr("qk_matmul_output_mode", 0) != 0):
            reasons.append(
                f"Attention qk_matmul_output_mode="
                f"{node.attr('qk_matmul_output_mode')} is not supported "
                "(only mode 0, the raw scaled QK matmul)")
    elif op == "MultiHeadAttention":
        if node.attr("num_heads") is None:
            reasons.append("MultiHeadAttention requires num_heads")
        if len(node.inputs) > 4 and node.inputs[4]:
            reasons.append(
                "MultiHeadAttention key_padding_mask is not supported")
        if any(node.inputs[i] for i in (6, 7) if len(node.inputs) > i):
            reasons.append(
                "MultiHeadAttention past_key/past_value (KV cache) inputs "
                "are not supported")
    elif op == "GridSample":
        mode = node.attr("mode", b"linear")
        if isinstance(mode, bytes):
            mode = mode.decode()
        if mode not in ("linear", "bilinear", "nearest"):
            reasons.append(f"GridSample mode '{mode}' is not supported")
        pad = node.attr("padding_mode", b"zeros")
        if isinstance(pad, bytes):
            pad = pad.decode()
        if pad not in ("zeros", "border"):
            reasons.append(
                f"GridSample padding_mode '{pad}' is not supported")
    elif op == "FusedMatMul":
        if node.attr("transBatchA", 0) or node.attr("transBatchB", 0):
            reasons.append(
                "FusedMatMul transBatchA/transBatchB are not supported")
    elif op == "BitShift":
        d = node.attr("direction")
        d = d.decode() if isinstance(d, bytes) else d
        if d not in ("LEFT", "RIGHT"):
            reasons.append(f"BitShift direction '{d}' is not supported")
    elif op == "STFT":
        if not node.attr("onesided", 1):
            reasons.append("STFT onesided=0 is not supported")
    elif op == "GatherND":
        if node.attr("batch_dims", 0):
            reasons.append("GatherND batch_dims>0 is not supported")
    elif op == "GroupNormalization":
        if node.attr("num_groups") is None:
            reasons.append("GroupNormalization requires num_groups")
    elif op == "If":
        if node.attr("then_branch") is None or \
                node.attr("else_branch") is None:
            reasons.append("If requires then_branch and else_branch "
                           "subgraph attributes")
    elif op == "Loop":
        if node.attr("body") is None:
            reasons.append("Loop requires a body subgraph attribute")
        if len(node.inputs) < 2 or not any(node.inputs[:2]):
            reasons.append(
                "Loop with neither trip count nor condition input")
    elif op == "Scan":
        if opset == 8:
            reasons.append(
                "opset-8 Scan (sequence_lens/batch form) is not supported")
        if node.attr("body") is None or \
                node.attr("num_scan_inputs") is None:
            reasons.append("Scan requires body and num_scan_inputs")
    elif op == "QLinearAveragePool":
        if node.attr("channels_last", 0):
            reasons.append(
                "QLinearAveragePool channels_last=1 is not supported")
    return reasons


def _input_findings(node, opset: int = 0) -> list[str]:
    """Statically-checkable *input-presence* limits: which optional input
    slots are wired is part of the serialized graph, so a missing required
    input is as preflightable as a bad attribute."""
    reasons = []
    op = node.op_type
    ins = list(node.inputs)
    if op == "Resize":
        if opset and opset < 11:
            if len(ins) < 2 or not ins[1]:
                reasons.append("opset-10 Resize requires a scales input")
        elif not any(ins[2:4]):
            reasons.append("Resize requires a scales or sizes input")
    elif op == "Upsample":
        if opset >= 9 and (len(ins) < 2 or not ins[1]) and \
                node.attr("scales") is None:
            reasons.append("Upsample requires scales (input or attribute)")
    return reasons


def preflight(model: Model | bytes | str, evaluator=None) -> list[Finding]:
    """Walk the whole graph; return every supportability issue at once.

    ``evaluator`` is the evaluator instance (or class) whose ``op_*``
    handlers define the supported set — defaults to the stock lowering
    evaluator, so custom evaluators (e.g. the int8 path) are checked
    against their own handler surface.
    """
    if not isinstance(model, Model):
        model = load_model(model)
    if evaluator is None:
        from .lowering import _Evaluator

        evaluator = _Evaluator
    graph = model.graph
    findings: list[Finding] = []

    init_names = set(graph.initializers)
    for vi in graph.inputs:
        if vi.name in init_names:
            continue
        if vi.elem_type not in _NP_DTYPES:
            findings.append(Finding(
                vi.name, "<input>",
                f"unsupported input dtype "
                f"{_DT_NAMES.get(vi.elem_type, vi.elem_type)}",
            ))

    for name, t in graph.initializers.items():
        if t.data_type not in _NP_DTYPES:
            findings.append(Finding(
                name, "<initializer>",
                f"unsupported tensor dtype "
                f"{_DT_NAMES.get(t.data_type, t.data_type)}",
            ))
        elif t.array is None and t.data_location == LOCATION_EXTERNAL:
            findings.append(Finding(
                name, "<initializer>",
                "external weight data was never resolved (load the model "
                "through load_model with its base directory)",
            ))

    seen_missing: set[str] = set()

    def _walk(graph):
        for node in graph.nodes:
            _check_node(graph, node)
            for a in node.attrs.values():
                if a.g is not None:  # If branches, Loop/Scan bodies
                    _walk(a.g)

    def _check_node(graph, node):
        if node.op_type == "Constant":
            t = node.attr("value")
            if (t is not None and getattr(t, "array", None) is None
                    and getattr(t, "data_type", 1) not in _NP_DTYPES):
                findings.append(Finding(
                    node.name, "Constant",
                    f"unsupported constant dtype "
                    f"{_DT_NAMES.get(t.data_type, t.data_type)}",
                ))
            elif t is None or getattr(t, "array", None) is None:
                # No foldable payload: the numeric value_* spellings fold
                # (lowering._constant_payload); sparse/string ones do not.
                from .lowering import _constant_payload

                if _constant_payload(node) is None:
                    spelled = ", ".join(sorted(node.attrs)) or "<none>"
                    findings.append(Finding(
                        node.name, "Constant",
                        f"no foldable value attribute (has: {spelled}; "
                        "sparse_value / value_string(s) are unsupported)",
                    ))
            return
        if getattr(evaluator, f"op_{node.op_type}", None) is None:
            if node.op_type not in seen_missing:
                seen_missing.add(node.op_type)
                n = sum(1 for x in graph.nodes if x.op_type == node.op_type)
                count = f" ({n} occurrence{'s' if n > 1 else ''})" if n > 1 else ""
                findings.append(Finding(
                    node.name, node.op_type,
                    f"op is not supported by the lowering{count}",
                ))
            return
        opset = model.opset
        for reason in _attr_findings(node, opset):
            findings.append(Finding(node.name, node.op_type, reason))
        for reason in _input_findings(node, opset):
            findings.append(Finding(node.name, node.op_type, reason))

    _walk(graph)
    return findings


def preflight_or_raise(model: Model | bytes | str, evaluator=None) -> None:
    """Raise one :class:`OnnxGraphUnsupported` naming every issue."""
    findings = preflight(model, evaluator=evaluator)
    if findings:
        from ..errors import OnnxGraphUnsupported

        listing = "\n".join(f"  - {f.render()}" for f in findings)
        raise OnnxGraphUnsupported(len(findings), listing)
