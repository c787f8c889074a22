"""Graph-level fusion passes (the TensorRT layer-fusion analogue).

The shipped BirdNET graphs spell their spectrogram front-end as a chain of
ONNX nodes (reference manifests ``graph.notes``; synthesized at real scale
in :mod:`.fullscale`):

    Conv1d(stft_w, stride=hop)            # [B, 2*bins, T] windowed DFT
    -> Slice(re) / Slice(im)              # cos / sin banks
       (or the exporter spelling: one Split(axis=1) into equal halves)
    -> Mul, Mul, Add                      # power spectrum
       (squares also match the Pow(x, 2) spelling)
    -> Transpose(0,2,1)                   # [B, T, bins]
    -> MatMul(mel_fb) [x n banks]         # mel projection(s)
    -> Concat(axis=2)                     # when several banks
    -> Add(eps) -> Log                    # log compression

Executed node by node, the ``[B, 2*bins, T]`` spectrum is written to HBM
and re-read by the power ops and every mel bank — ~1.6 GB of traffic per
batch-256 inference for v2.4. :func:`fuse_mel_frontend` pattern-matches
the chain (conservatively: initializer-backed weights, chain-internal
tensors single-consumed and not graph outputs, exact re/im slice split)
and splices in a single ``BirdaFusedMelFrontend`` node that the evaluator
lowers to one Pallas kernel (``ops/stft_conv.py::fused_logmel``) emitting
the ~50 MB log-mel image directly.

Anything that does not match is left untouched — the pass is a pure
optimization with the node-by-node path as its semantics reference.
"""

from __future__ import annotations

import numpy as np

from .proto import Attribute, Graph, Node, Tensor, constant_payload

FUSED_OP = "BirdaFusedMelFrontend"


def fold_constant_nodes(graph: Graph) -> int:
    """Convert foldable ``Constant`` nodes into initializers (and drop the
    nodes) so the matchers see one spelling. Real exporters emit scalars —
    the eps of the Log chain, Slice starts/ends, Split sizes — as Constant
    *nodes*; every matcher here reads ``graph.initializers``, so without
    this pass a producer-shaped export silently falls back to node-by-node
    execution. Semantics-preserving: the evaluator folds Constant nodes
    into its constant pool the same way (``lowering._constant_payload``).
    Constants that are graph outputs, shadow an existing initializer, or
    use unfoldable spellings (sparse, strings) keep their node."""
    out_names = {vi.name for vi in graph.outputs}
    kept, n = [], 0
    for node in graph.nodes:
        if node.op_type == "Constant" and node.outputs and \
                node.outputs[0] not in out_names and \
                node.outputs[0] not in graph.initializers:
            v = constant_payload(node)
            if v is not None:
                a = np.asarray(v)
                graph.initializers[node.outputs[0]] = Tensor(
                    name=node.outputs[0], dims=tuple(a.shape), array=a)
                n += 1
                continue
        kept.append(node)
    if n:
        graph.nodes = kept
    return n


def _build_consumers(graph: Graph):
    """``(consumers, out_names, sole_consumer)`` over the current node
    list. Maps go stale after any splice — rebuild before re-matching."""
    consumers: dict[str, list[Node]] = {}
    for n in graph.nodes:
        for inp in n.inputs:
            # Dedupe: Mul(x, x) is ONE consumer of x, not two.
            if inp and (inp not in consumers
                        or consumers[inp][-1] is not n):
                consumers.setdefault(inp, []).append(n)
    out_names = {vi.name for vi in graph.outputs}

    def sole_consumer(tensor: str, op_type: str | None = None):
        """The unique consumer of ``tensor`` (None if shared or an
        output); optionally requiring its op type."""
        if tensor in out_names:
            return None
        cons = consumers.get(tensor, [])
        if len(cons) != 1:
            return None
        if op_type is not None and cons[0].op_type != op_type:
            return None
        return cons[0]

    return consumers, out_names, sole_consumer


def _fresh_init_name(graph: Graph, base: str) -> str:
    """``base``, uniquified against the existing initializers. Exporter
    dedup passes can make two fused chains share a parameter initializer
    (e.g. identical BN gammas merged to one tensor); deriving the folded
    names from that shared input alone would cross-wire the chains'
    folds."""
    name, n = base, 1
    while name in graph.initializers:
        n += 1
        name = f"{base}_{n}"
    return name


def _iter_nodes_recursive(graph: Graph):
    """Every node in ``graph`` including If/Loop/Scan body subgraphs
    (whose nodes close over outer-scope tensors by name)."""
    stack = list(graph.nodes)
    while stack:
        n = stack.pop()
        yield n
        for a in n.attrs.values():
            if a.g is not None:
                stack.extend(a.g.nodes)


def _drop_dead_inits(graph: Graph, chain) -> None:
    """Delete initializers the spliced-out ``chain`` alone consumed.
    "Still used" must count subgraph-body references and the graph's
    declared inputs: IR-3 exports list initializers in ``graph.inputs``,
    and deleting one would turn it into a required runtime input."""
    chain_inits = {
        i for n in chain for i in n.inputs if i in graph.initializers
    }
    still_used = {i for n in _iter_nodes_recursive(graph) for i in n.inputs}
    still_used.update(vi.name for vi in graph.outputs)
    still_used.update(vi.name for vi in graph.inputs)
    for name in chain_inits - still_used:
        del graph.initializers[name]


def _attr_i(name: str, v: int) -> Attribute:
    return Attribute(name=name, i=int(v))


def _attr_f(name: str, v: float) -> Attribute:
    return Attribute(name=name, f=float(v))


def _attr_s(name: str, v: str) -> Attribute:
    return Attribute(name=name, s=v.encode())


def _slice_params(graph: Graph, node: Node):
    """(starts, ends, axes) for a Slice node from attrs or initializer
    inputs; None when dynamic (non-initializer) inputs are used."""
    if len(node.inputs) == 1:
        st, en, ax = (node.attr("starts"), node.attr("ends"),
                      node.attr("axes"))
        if st is None or en is None:
            return None
        return list(st), list(en), (list(ax) if ax is not None else None)
    vals = []
    for name in node.inputs[1:4]:
        if not name:
            vals.append(None)
            continue
        t = graph.initializers.get(name)
        if t is None or t.array is None:
            return None
        vals.append([int(v) for v in np.asarray(t.array).reshape(-1)])
    while len(vals) < 3:
        vals.append(None)
    if len(node.inputs) > 4 and node.inputs[4]:
        t = graph.initializers.get(node.inputs[4])
        if t is None or t.array is None:
            return None
        if any(int(v) != 1 for v in np.asarray(t.array).reshape(-1)):
            return None  # strided slices never match the re/im split
    st, en, ax = vals
    if st is None or en is None:
        return None
    return st, en, ax


def _scalar_init(graph: Graph, name: str):
    t = graph.initializers.get(name)
    if t is None or t.array is None:
        return None
    a = np.asarray(t.array)
    if a.size != 1:
        return None
    return float(a.reshape(()))


def fuse_mel_frontend(graph: Graph) -> int:
    """Splice matching spectrogram-front-end→…→Log chains in place;
    returns the number of chains fused (0 = graph untouched). Two chain
    spellings match: the Conv1d-STFT form (the v3.0 manifest chain,
    :func:`_match_chain`) and the opset-17 ``STFT``-op form a TF export
    traces (:func:`_match_chain_stft`)."""
    fold_constant_nodes(graph)
    consumers, out_names, sole_consumer = _build_consumers(graph)
    fused = 0
    for anchor in list(graph.nodes):
        match = _match_chain(graph, anchor, consumers, out_names,
                             sole_consumer)
        if match is None:
            match = _match_chain_stft(graph, anchor, consumers, out_names,
                                      sole_consumer)
        if match is None:
            continue
        _apply(graph, match)
        fused += 1
        # Maps are stale after a splice; one chain per graph in practice.
        break
    return fused


def _square_of(graph, sole_consumer, tensor: str):
    """The node squaring ``tensor`` — ``Mul(x, x)`` or the exporter
    spelling ``Pow(x, 2)``; None when it is anything else."""
    node = sole_consumer(tensor)
    if node is None:
        return None
    if node.op_type == "Mul" and node.inputs == [tensor] * 2:
        return node
    if node.op_type == "Pow" and node.inputs[0] == tensor and \
            _scalar_init(graph, node.inputs[1]) == 2.0:
        return node
    return None


def _match_mel_tail(graph, spec_name: str, bins: int, consumers,
                    out_names, sole_consumer):
    """Mel matmul(s) → [Concat] → Add(eps) → Log off the ``[B, T, bins]``
    power spectrum ``spec_name``. Returns ``(tail_nodes, fb_cat, log,
    eps)`` or None; shared by the Conv1d and STFT-op chain matchers."""
    if spec_name in out_names:
        return None
    mm_nodes = consumers.get(spec_name, [])
    if not mm_nodes or any(n.op_type != "MatMul" for n in mm_nodes):
        return None
    fbs = []
    for mm in mm_nodes:
        if mm.inputs[0] != spec_name:
            return None
        fb = graph.initializers.get(mm.inputs[1])
        if fb is None or fb.array is None or fb.array.ndim != 2 or \
                fb.array.shape[0] != bins:
            return None
        fbs.append((mm, fb.array))
    if len(mm_nodes) == 1:
        mel_out = mm_nodes[0].outputs[0]
        chain_tail = list(mm_nodes)
        fb_cat = fbs[0][1]
    else:
        concat = sole_consumer(mm_nodes[0].outputs[0], "Concat")
        if concat is None or concat.attr("axis") not in (2, -1):
            return None
        # Every matmul off the spectrum must feed this Concat, exactly
        # once — a stray bank (e.g. an auxiliary head's matmul) would
        # otherwise be deleted with the chain, orphaning its consumers.
        if sorted(concat.inputs) != sorted(m.outputs[0] for m in mm_nodes):
            return None
        # Concat input order defines the bank order in the fused matrix.
        order = []
        for inp in concat.inputs:
            mm = next((m for m, _ in fbs if m.outputs[0] == inp), None)
            if mm is None or sole_consumer(inp, "Concat") is not concat:
                return None
            order.append(next(a for m, a in fbs if m is mm))
        mel_out = concat.outputs[0]
        chain_tail = list(mm_nodes) + [concat]
        fb_cat = np.concatenate(order, axis=1)

    eps_add = sole_consumer(mel_out, "Add")
    if eps_add is None:
        return None
    others = [i for i in eps_add.inputs if i != mel_out]
    if len(others) != 1:
        return None
    eps = _scalar_init(graph, others[0])
    if eps is None or not (0.0 < eps < 1.0):
        return None
    log = sole_consumer(eps_add.outputs[0], "Log")
    if log is None:
        return None
    return chain_tail + [eps_add, log], fb_cat, log, eps


def _match_chain(graph, conv, consumers, out_names, sole_consumer):
    if conv.op_type != "Conv" or len(conv.inputs) < 2 or \
            (len(conv.inputs) > 2 and conv.inputs[2]):
        return None  # bias-less single-input conv only
    w = graph.initializers.get(conv.inputs[1])
    if w is None or w.array is None or w.array.ndim != 3 or \
            w.array.shape[1] != 1 or w.array.shape[2] < 256:
        return None
    if w.array.shape[0] % 2:
        return None
    strides = conv.attr("strides")
    dil = conv.attr("dilations")
    pads = conv.attr("pads")
    if not strides or len(strides) != 1:
        return None
    if dil is not None and list(dil) != [1]:
        return None
    if pads is not None and any(int(p) for p in pads):
        return None
    if conv.attr("group", 1) != 1:
        return None
    if conv.attr("auto_pad", b"NOTSET") not in (b"NOTSET", b"VALID"):
        return None
    bins = w.array.shape[0] // 2

    cons = [] if conv.outputs[0] in out_names else \
        consumers.get(conv.outputs[0], [])
    if len(cons) == 2 and all(n.op_type == "Slice" for n in cons):
        re_sl = im_sl = None
        for sl in cons:
            p = _slice_params(graph, sl)
            if p is None:
                return None
            st, en, ax = p
            if ax is not None and list(ax) != [1]:
                return None
            if st == [0] and en == [bins]:
                re_sl = sl
            elif st == [bins] and en[0] >= 2 * bins:
                im_sl = sl
        if re_sl is None or im_sl is None:
            return None
        re_name, im_name = re_sl.outputs[0], im_sl.outputs[0]
        split_nodes = [re_sl, im_sl]
    elif len(cons) == 1 and cons[0].op_type == "Split":
        # Exporter spelling: one Split(axis=1) into equal cos/sin halves
        # instead of two Slices. Which half is cos vs sin is irrelevant —
        # the chain squares and sums both.
        sp = cons[0]
        if sp.attr("axis", 0) != 1 or len(sp.outputs) != 2:
            return None
        sizes = sp.attr("split")
        if sizes is None and len(sp.inputs) > 1 and sp.inputs[1]:
            t = graph.initializers.get(sp.inputs[1])
            if t is None or t.array is None:
                return None
            sizes = [int(v) for v in np.asarray(t.array).reshape(-1)]
        if sizes is not None and list(sizes) != [bins, bins]:
            return None  # absent sizes = equal split of 2*bins = [bins, bins]
        re_name, im_name = sp.outputs
        split_nodes = [sp]
    else:
        return None

    re_mul = _square_of(graph, sole_consumer, re_name)
    im_mul = _square_of(graph, sole_consumer, im_name)
    if re_mul is None or im_mul is None:
        return None
    add = sole_consumer(re_mul.outputs[0], "Add")
    if add is None or add is not sole_consumer(im_mul.outputs[0], "Add"):
        return None
    if set(add.inputs) != {re_mul.outputs[0], im_mul.outputs[0]}:
        return None
    tr = sole_consumer(add.outputs[0], "Transpose")
    if tr is None or list(tr.attr("perm") or []) != [0, 2, 1]:
        return None

    # One or more mel matmuls off the transposed power spectrum.
    tail = _match_mel_tail(graph, tr.outputs[0], bins, consumers,
                           out_names, sole_consumer)
    if tail is None:
        return None
    tail_nodes, fb_cat, log, eps = tail

    chain = [conv, *split_nodes, re_mul, im_mul, add, tr, *tail_nodes]
    return {
        "chain": chain, "anchor": conv, "sig_name": conv.inputs[0],
        "w_name": conv.inputs[1], "log": log, "fb_cat": fb_cat,
        "hop": int(strides[0]), "eps": eps, "bins": bins, "kind": "conv",
    }


def _squeeze_axes(graph, node):
    """The static axes of a Squeeze node (attr or initializer input),
    or None when dynamic/absent."""
    if node.op_type != "Squeeze":
        return None
    ax = node.attr("axes")
    if ax is None and len(node.inputs) > 1 and node.inputs[1]:
        t = graph.initializers.get(node.inputs[1])
        if t is None or t.array is None:
            return None
        ax = np.asarray(t.array).reshape(-1)
    if ax is None:
        return None
    return [int(v) for v in ax]


def _match_chain_stft(graph, stft, consumers, out_names, sole_consumer):
    """The opset-17 ``STFT``-op spelling of the front-end chain — what a
    producer that keeps ``tf.signal.stft`` as the ONNX signal op exports
    (oracled in ``tests/test_tf_oracle.py``):

        STFT(sig, step, win) -> Slice(re)/Slice(im) on the complex axis
        -> Mul/Pow squares -> Add -> Squeeze -> MatMul(mel) [-> Concat]
        -> Add(eps) -> Log

    (squeezing re/im before squaring also matches). The windowed DFT
    becomes the conv-weight form the fused kernel already runs — rows
    ``[win*cos ; -win*sin]`` — synthesized from the window and frame
    length at apply time, so both spellings share one kernel."""
    if stft.op_type != "STFT":
        return None
    if stft.attr("onesided", 1) != 1:
        return None
    ins = list(stft.inputs) + [""] * (4 - len(stft.inputs))
    sig_name, step_name, win_name, flen_name = ins[:4]
    hop = _scalar_init(graph, step_name) if step_name else None
    if hop is None or hop <= 0 or hop != int(hop):
        return None
    hop = int(hop)
    win_t = graph.initializers.get(win_name) if win_name else None
    if win_t is None or win_t.array is None or win_t.array.ndim != 1:
        return None  # window-less (rectangular) STFT: not an export shape
    k = int(win_t.array.shape[0])
    if k < 256:
        return None
    if flen_name:
        fl = _scalar_init(graph, flen_name)
        if fl is None or int(fl) != k:
            return None  # fft_length != window length: zero-padded DFT
    bins = k // 2 + 1

    cons = [] if stft.outputs[0] in out_names else \
        consumers.get(stft.outputs[0], [])
    complex_axes = (3, -1)
    if len(cons) == 2 and all(n.op_type == "Slice" for n in cons):
        re_name = im_name = None
        for sl in cons:
            p = _slice_params(graph, sl)
            if p is None:
                return None
            st, en, ax = p
            if ax is None or len(ax) != 1 or int(ax[0]) not in complex_axes:
                return None
            if st == [0] and en == [1]:
                re_name = sl.outputs[0]
            elif st == [1] and en[0] >= 2:
                im_name = sl.outputs[0]
        if re_name is None or im_name is None:
            return None
        split_nodes = list(cons)
    elif len(cons) == 1 and cons[0].op_type == "Split":
        sp = cons[0]
        if sp.attr("axis", 0) not in complex_axes or len(sp.outputs) != 2:
            return None
        sizes = sp.attr("split")
        if sizes is None and len(sp.inputs) > 1 and sp.inputs[1]:
            t = graph.initializers.get(sp.inputs[1])
            if t is None or t.array is None:
                return None
            sizes = [int(v) for v in np.asarray(t.array).reshape(-1)]
        if sizes is not None and list(sizes) != [1, 1]:
            return None
        re_name, im_name = sp.outputs
        split_nodes = [sp]
    else:
        return None

    # Optional per-component Squeeze of the complex axis before squaring.
    squeeze_nodes = []
    sq_re = sole_consumer(re_name, "Squeeze")
    sq_im = sole_consumer(im_name, "Squeeze")
    pre_squeezed = False
    if sq_re is not None and sq_im is not None:
        ax_re, ax_im = _squeeze_axes(graph, sq_re), _squeeze_axes(graph,
                                                                  sq_im)
        if ax_re is not None and ax_im is not None and \
                len(ax_re) == 1 and ax_re[0] in complex_axes and \
                len(ax_im) == 1 and ax_im[0] in complex_axes:
            re_name, im_name = sq_re.outputs[0], sq_im.outputs[0]
            squeeze_nodes = [sq_re, sq_im]
            pre_squeezed = True

    re_mul = _square_of(graph, sole_consumer, re_name)
    im_mul = _square_of(graph, sole_consumer, im_name)
    if re_mul is None or im_mul is None:
        return None
    add = sole_consumer(re_mul.outputs[0], "Add")
    if add is None or add is not sole_consumer(im_mul.outputs[0], "Add"):
        return None
    if set(add.inputs) != {re_mul.outputs[0], im_mul.outputs[0]}:
        return None

    if pre_squeezed:
        pow_name = add.outputs[0]
    else:
        sq = sole_consumer(add.outputs[0], "Squeeze")
        if sq is None:
            return None
        ax = _squeeze_axes(graph, sq)
        if ax is None or len(ax) != 1 or ax[0] not in complex_axes:
            return None
        squeeze_nodes = [sq]
        pow_name = sq.outputs[0]

    tail = _match_mel_tail(graph, pow_name, bins, consumers, out_names,
                           sole_consumer)
    if tail is None:
        return None
    tail_nodes, fb_cat, log, eps = tail

    chain = [stft, *split_nodes, re_mul, im_mul, add, *squeeze_nodes,
             *tail_nodes]
    return {
        "chain": chain, "anchor": stft, "sig_name": sig_name,
        "win": np.asarray(win_t.array, np.float64), "log": log,
        "fb_cat": fb_cat, "hop": hop, "eps": eps, "bins": bins,
        "frame": k, "kind": "stft",
    }


def _apply(graph: Graph, m: dict) -> None:
    anchor = m["anchor"]
    fb_name = _fresh_init_name(graph, m["w_name"] + "__fused_melfb") \
        if m["kind"] == "conv" else \
        _fresh_init_name(graph, (anchor.name or "stft") + "__fused_melfb")
    fb = np.ascontiguousarray(m["fb_cat"].astype(np.float32))
    graph.initializers[fb_name] = Tensor(
        name=fb_name, dims=tuple(fb.shape), array=fb,
    )
    if m["kind"] == "stft":
        # Synthesize the windowed-DFT conv weight the fused kernel runs:
        # rows [win*cos(2π f t / K) ; -win*sin(...)] for the onesided
        # bins — exactly what op_STFT computes, so both spellings share
        # one kernel and one numerics reference.
        k, bins = m["frame"], m["bins"]
        t = np.arange(k, dtype=np.float64)
        f = np.arange(bins, dtype=np.float64)[:, None]
        ang = 2.0 * np.pi * f * t[None, :] / k
        win = m["win"]
        w = np.concatenate(
            [win * np.cos(ang), -win * np.sin(ang)], axis=0,
        ).astype(np.float32)[:, None, :]
        w_name = _fresh_init_name(
            graph, (anchor.name or "stft") + "__fused_stft_w")
        graph.initializers[w_name] = Tensor(
            name=w_name, dims=tuple(w.shape), array=np.ascontiguousarray(w),
        )
    else:
        w_name = m["w_name"]
    fused = Node(
        op_type=FUSED_OP,
        name=(anchor.name or "stft") + "_fused_melfrontend",
        inputs=[m["sig_name"], w_name, fb_name],
        outputs=[m["log"].outputs[0]],
        attrs={
            "hop": _attr_i("hop", m["hop"]),
            "eps": _attr_f("eps", m["eps"]),
            "src": _attr_s("src", m["kind"]),
        },
    )
    chain_set = set(map(id, m["chain"]))
    idx = graph.nodes.index(anchor)
    graph.nodes = [n for n in graph.nodes if id(n) not in chain_set]
    graph.nodes.insert(idx, fused)
    # Drop initializers the chain alone consumed (the per-bank mel
    # matrices are large enough to be param-lifted and shipped to the
    # device — dead weight once the concatenated copy replaces them).
    _drop_dead_inits(graph, m["chain"])
