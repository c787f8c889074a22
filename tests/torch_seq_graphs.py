"""A spectrogram transformer with BirdNET v3.0's I/O contract, written as
an ONNX graph in the forms transformer exporters write: the layers as one
scan-over-layers ``Loop`` (the jax2tf/tf2onnx form) in ONNX Runtime's
optimized spelling (com.microsoft ``MultiHeadAttention``, ``FusedMatMul``,
``SkipLayerNormalization``, ``BiasGelu``), and the pooling and head behind
an ``If`` on a graph-static flag, the head weight a branch initializer.

``waveform [batch, 160000]`` at 32 kHz -> ``predictions [batch, 11560]``
(sigmoid) and ``embeddings [batch, hidden]``, random weights from a seed:

1. BirdNET v3.0's front end (``fullscale._frontend`` of
   ``BIRDNET_V30_SPEC``: the Conv1d-STFT, power, 128 mels, log and
   per-sample standardization), which the bf16 route fuses into one
   ``fused_logmel`` node;
2. a 16x16 patch embedding at stride 10 (AST, Gong et al. 2021, base
   configuration) and a learned position embedding;
3. the encoder: ``layers`` post-norm layers as one ``Loop`` over stacked
   per-layer weights, each layer ``Gather``-ing its weights by the
   iteration number from the outer scope;
4. mean pooling over the tokens and the head ``Gemm`` in the then-branch
   of an ``If`` (the else-branch, never taken, max-pools).

:data:`FULL` is AST-base width and depth (12 layers, hidden 768, 12 heads,
MLP 3072, 588 tokens, about 95 M parameters); :data:`TINY` is the CPU
tests' size. It imports numpy and the port's own ``onnx/encode.py`` and
``onnx/fullscale.py`` only, so that a machine without jax can build it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from birda_tpu_torch.onnx import encode as E
from birda_tpu_torch.onnx import fullscale as fs

MS = "com.microsoft"


@dataclass(frozen=True)
class SeqSpec:
    """One spectrogram transformer: its front end, encoder and head."""

    name: str
    frontend: fs.GraphSpec
    layers: int
    hidden: int
    heads: int
    mlp: int
    patch: int = 16
    stride: int = 10
    num_classes: int = 11_560


FULL = SeqSpec("birdnet-v30-seq-transformer", fs.BIRDNET_V30_SPEC,
               layers=12, hidden=768, heads=12, mlp=3072)
TINY = SeqSpec("birdnet-v30-seq-transformer-tiny",
               fs.tiny_spec(fs.BIRDNET_V30_SPEC), layers=2, hidden=64,
               heads=4, mlp=128)


@dataclass
class SeqGraph:
    spec: SeqSpec
    model_bytes: bytes
    param_count: int
    #: Multiply-accumulates for one segment.
    macs: int
    tokens: int


def _token_grid(spec: SeqSpec) -> tuple[int, int, int]:
    """(front-end frames, patch rows, patch columns)."""
    fe = spec.frontend
    frames = 1 + (fe.sample_count - fe.n_fft) // fe.hop
    mels = sum(m for m, _, _ in fe.mel_banks)
    grid = [(n - spec.patch) // spec.stride + 1 for n in (frames, mels)]
    return frames, grid[0], grid[1]


def build(spec: SeqSpec, seed: int = 1) -> SeqGraph:
    """The ONNX bytes of ``spec`` with weights from ``seed``."""
    b = fs._Builder(seed)
    img, _ = fs._frontend(b, spec.frontend)
    _, rows, cols = _token_grid(spec)
    tokens = rows * cols
    h, L, p = spec.hidden, spec.layers, spec.patch

    # Patch embedding: [B,1,T,M] -> [B,h,rows,cols] -> [B,tokens,h].
    pw = b.weight("patch_w", (h, 1, p, p), p * p)
    pb = b.weight("patch_b", (h,), 1, gain=0.02)
    b.macs += h * p * p * tokens
    pe = b.add("Conv", [img, pw, pb], attrs=[
        E.attr_ints("kernel_shape", [p, p]),
        E.attr_ints("strides", [spec.stride, spec.stride])])
    flat = b.add("Reshape", [pe, b.init("tok_shape", np.array(
        [0, h, -1], np.int64), count=False)])
    tok = b.add("Transpose", [flat], attrs=[E.attr_ints("perm", [0, 2, 1])])
    x0 = b.add("Add", [tok, b.weight("pos_emb", (1, tokens, h), 1,
                                     gain=0.02)])

    # Stacked per-layer weights, read by the Loop body from the outer scope.
    def stacked(tag, shape, fan_in, gain=1.0):
        return b.weight(tag, (L,) + shape, fan_in, gain)

    def around_one(tag, shape):
        name = b.fresh(tag)
        b.param_count += int(np.prod((L,) + shape))
        arr = b._rng(name).uniform(0.8, 1.2, (L,) + shape).astype(np.float32)
        b.inits.append(E.tensor(name, arr))
        return name

    w = {
        "wqkv": stacked("enc_wqkv", (h, 3 * h), h),
        "bqkv": stacked("enc_bqkv", (3 * h,), 1, 0.02),
        "wo": stacked("enc_wo", (h, h), h),  # [out, in]: FusedMatMul transB
        "bo": stacked("enc_bo", (h,), 1, 0.02),
        "g1": around_one("enc_ln1_g", (h,)),
        "b1n": stacked("enc_ln1_b", (h,), 1, 0.02),
        "w1": stacked("enc_w1", (h, spec.mlp), h),
        "b1": stacked("enc_b1", (spec.mlp,), 1, 0.02),
        "w2": stacked("enc_w2", (spec.mlp, h), spec.mlp),
        "b2": stacked("enc_b2", (h,), 1, 0.02),
        "g2": around_one("enc_ln2_g", (h,)),
        "b2n": stacked("enc_ln2_b", (h,), 1, 0.02),
    }
    b.macs += L * tokens * (3 * h * h + h * h + 2 * h * spec.mlp
                            + 2 * tokens * h)

    def n(op, ins, outs, attrs=(), domain=""):
        return E.node(op, ins, outs, name=outs[0], attrs=list(attrs),
                      domain=domain)

    body_nodes = [n("Gather", [w[k], "it"], [f"{k}_i"]) for k in w]
    body_nodes += [
        n("MatMul", ["x_in", "wqkv_i"], ["qkv"]),
        n("Split", ["qkv", "qkv_split"], ["q", "k", "v"],
          [E.attr_int("axis", 2)]),
        n("MultiHeadAttention", ["q", "k", "v", "bqkv_i"], ["attn"],
          [E.attr_int("num_heads", spec.heads)], MS),
        n("FusedMatMul", ["attn", "wo_i"], ["proj"],
          [E.attr_int("transB", 1)], MS),
        n("SkipLayerNormalization", ["proj", "x_in", "g1_i", "b1n_i",
                                     "bo_i"], ["h1"],
          [E.attr_float("epsilon", 1e-6)], MS),
        n("MatMul", ["h1", "w1_i"], ["f1"]),
        n("BiasGelu", ["f1", "b1_i"], ["act"], domain=MS),
        n("MatMul", ["act", "w2_i"], ["f2"]),
        n("SkipLayerNormalization", ["f2", "h1", "g2_i", "b2n_i", "b2_i"],
          ["x_out"], [E.attr_float("epsilon", 1e-6)], MS),
        n("Identity", ["cond_in"], ["cond_out"]),
    ]
    body = E.graph(
        body_nodes,
        inputs=[E.value_info("it", [], 7), E.value_info("cond_in", [], 9),
                E.value_info("x_in", ["batch", tokens, h])],
        outputs=[E.value_info("cond_out", [], 9),
                 E.value_info("x_out", ["batch", tokens, h])],
        initializers=[E.tensor("qkv_split", np.array([h, h, h], np.int64))],
        graph_name="encoder_layer")
    enc = b.add("Loop", [b.init("n_layers", np.array(L, np.int64),
                                count=False), "", x0],
                attrs=[E.attr_graph("body", body)])

    # Pooling and head: an If on a graph-static flag, the head weight a
    # then-branch initializer.
    c = spec.num_classes
    head_w = b._rng("head_w").standard_normal((h, c), dtype=np.float32)
    head_w *= np.float32(1.0 / np.sqrt(h))
    head_b = np.full(c, -3.0, np.float32)
    b.param_count += head_w.size + head_b.size
    b.macs += h * c
    then_g = E.graph(
        [n("ReduceMean", [enc], ["pooled"], [E.attr_ints("axes", [1]),
                                             E.attr_int("keepdims", 0)]),
         n("Gemm", ["pooled", "head_w", "head_b"], ["logits_t"])],
        inputs=[],
        outputs=[E.value_info("pooled", ["batch", h]),
                 E.value_info("logits_t", ["batch", c])],
        initializers=[E.tensor("head_w", head_w),
                      E.tensor("head_b", head_b)], graph_name="mean_pool")
    else_g = E.graph(
        [n("ReduceMax", [enc], ["maxed"], [E.attr_ints("axes", [1]),
                                           E.attr_int("keepdims", 0)]),
         n("ReduceMean", ["maxed"], ["level"], [E.attr_ints("axes", [1]),
                                                E.attr_int("keepdims", 1)]),
         n("Expand", ["level", "wide"], ["logits_e"])],
        inputs=[],
        outputs=[E.value_info("maxed", ["batch", h]),
                 E.value_info("logits_e", ["batch", c])],
        initializers=[E.tensor("wide", np.array([1, c], np.int64))],
        graph_name="max_pool")
    b.nodes.append(E.node(
        "If", [b.init("mean_pool", np.array(True), count=False)],
        ["embeddings", "logits"], name="pool_head",
        attrs=[E.attr_graph("then_branch", then_g),
               E.attr_graph("else_branch", else_g)]))
    b.add("Sigmoid", ["logits"], out="predictions")

    fe = spec.frontend
    model_bytes = E.model(
        b.nodes,
        inputs=[E.value_info("waveform", ["batch", fe.sample_count])],
        outputs=[E.value_info("predictions", ["batch", c]),
                 E.value_info("embeddings", ["batch", h])],
        initializers=b.inits, opset=17, graph_name=spec.name)
    return SeqGraph(spec, model_bytes, b.param_count, b.macs, tokens)
