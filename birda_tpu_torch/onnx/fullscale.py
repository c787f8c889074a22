"""Full-scale ONNX fixtures of the shipped model families' graphs.

The real model assets cannot be downloaded in the build environment, so this
module synthesizes ONNX graphs with the **real op mix at real dimensions** —
in-graph DSP front-end, NCHW conv backbone, class/embedding heads — with
seeded random weights. They serve two purposes:

- **Parity verification**: the ONNX->JAX lowering is checked end-to-end
  against an independent torch evaluation of the same graph bytes
  (``tests/test_fullscale.py``), de-risking score parity before the real
  assets are present (SURVEY §7 "hard parts": this, not throughput, is the
  project risk).
- **Benchmark anchoring**: ``bench.py`` runs these through the lowering on
  the chip, so the headline number reflects *their* graphs on our compiler,
  not a self-designed backbone.

Front-end forms follow the reference's manifests:

- BirdNET v3.0: "in-graph ONNX STFT replaced by an equivalent Conv1d"
  (upstream birda's ``manifests/BirdNET-v3.0-Models.models.json``
  ``graph.notes``) — windowed DFT cos/sin banks as one strided ``Conv``.
- Perch v2 ships with-DFT and ``no_dft`` graph variants
  (``Perch-v2-Models.models.json`` ``notes``; the DFT op is why OpenVINO
  can't run the with-DFT build) — the with-DFT form here frames via a
  strided identity ``Conv`` and applies the ONNX ``DFT`` op.
- BirdNET v2.4 carries a 48 kHz spectrogram front-end in-graph
  (SURVEY §2.1 "In-graph DSP front-ends"); modeled as the same Conv1d-STFT
  with two mel banks concatenated (low/high band), EfficientNet-B0-class
  backbone, 6,522 sigmoid outputs + 1,024-d embeddings.

Weight *values* are random (seeded, reproducible); weight *shapes*, op
sequence, layout (NCHW), and output contracts match §2.2. Parameter budgets
are pinned to the real asset sizes in tests: v2.4 ≈ 50 MB, v3.0 fp32 =
557,212,256 bytes (≈139 M params), Perch fp32 = 409,148,616 bytes (≈102 M).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from ..ops.melspec import hann, mel_filterbank
from . import encode as E


@dataclass(frozen=True)
class GraphSpec:
    """Architecture of one synthesized family graph."""

    name: str
    sample_count: int
    sample_rate: int
    n_fft: int
    hop: int
    #: (n_mels, fmin, fmax) per mel bank; banks concatenate on the mel axis.
    mel_banks: tuple
    stem: int
    #: (features, repeats, kernel, stride, expand, fused) — EfficientNet
    #: block table; ``fused`` uses a full kxk expand conv instead of
    #: 1x1-expand + depthwise.
    blocks: tuple
    head_features: int
    embedding_dim: int
    num_classes: int
    activation: str = "sigmoid"  # or "softmax"
    frontend: str = "conv1d_stft"  # or "dft"


#: BirdNET v2.4: 48 kHz / 3 s / 144,000 -> 6,522 sigmoid + 1,024-d emb
#: (registry.json ``birdnet-v24``; SURVEY §2.2). EfficientNet-B0 block table.
BIRDNET_V24_SPEC = GraphSpec(
    name="birdnet-v24-fullscale",
    sample_count=144_000, sample_rate=48_000, n_fft=2048, hop=278,
    mel_banks=((96, 0.0, 3000.0), (96, 500.0, 15_000.0)),
    stem=32,
    blocks=(
        (16, 1, 3, 1, 1, False), (24, 2, 3, 2, 6, False),
        (40, 2, 5, 2, 6, False), (80, 3, 3, 2, 6, False),
        (112, 3, 5, 1, 6, False), (192, 4, 5, 2, 6, False),
        (320, 1, 3, 1, 6, False),
    ),
    head_features=1280, embedding_dim=1024, num_classes=6522,
)

#: BirdNET v3.0 preview3.1: 32 kHz / 5 s / 160,000 -> predictions
#: [batch,11560] sigmoid + embeddings [batch,1280]
#: (manifests/BirdNET-v3.0-Models.models.json input/outputs blocks);
#: Conv1d-STFT front-end per graph.notes. EfficientNetV2-L-class block table
#: sized to the 557 MB fp32 asset (~139 M params).
BIRDNET_V30_SPEC = GraphSpec(
    name="birdnet-v30-fullscale",
    sample_count=160_000, sample_rate=32_000, n_fft=1024, hop=320,
    mel_banks=((128, 50.0, 16_000.0),),
    stem=32,
    blocks=(
        (32, 4, 3, 1, 1, True), (64, 7, 3, 2, 4, True),
        (96, 7, 3, 2, 4, True), (192, 10, 3, 2, 4, False),
        (224, 19, 3, 1, 6, False), (384, 25, 3, 2, 6, False),
        (640, 7, 3, 1, 6, False),
    ),
    head_features=1280, embedding_dim=1280, num_classes=11_560,
)

#: Perch v2: 32 kHz / 5 s / 160,000 -> 14,795 softmax
#: (``src/inference/geomodel.rs:5,24``), in-graph DFT op
#: (Perch-v2-Models.models.json backend notes), EfficientNetV2-M-class
#: block table sized to the 409 MB fp32 asset (~102 M params).
PERCH_V2_SPEC = GraphSpec(
    name="perch-v2-fullscale",
    sample_count=160_000, sample_rate=32_000, n_fft=640, hop=320,
    mel_banks=((160, 60.0, 16_000.0),),
    stem=32,
    blocks=(
        (24, 3, 3, 1, 1, True), (48, 5, 3, 2, 4, True),
        (80, 5, 3, 2, 4, True), (160, 7, 3, 2, 4, False),
        (176, 14, 3, 1, 6, False), (352, 18, 3, 2, 6, False),
        (640, 5, 3, 1, 6, False),
    ),
    head_features=1536, embedding_dim=1536, num_classes=14_795,
    activation="softmax", frontend="dft",
)

SPECS = {
    "birdnet-v24": BIRDNET_V24_SPEC,
    "birdnet-v30": BIRDNET_V30_SPEC,
    "perch-v2": PERCH_V2_SPEC,
}


def tiny_spec(base: GraphSpec) -> GraphSpec:
    """Same op mix, ~1000x fewer FLOPs — the CI-speed variant."""
    return GraphSpec(
        name=base.name + "-tiny",
        sample_count=base.sample_count, sample_rate=base.sample_rate,
        n_fft=base.n_fft, hop=base.hop * 8,
        mel_banks=tuple((max(8, m // 4), lo, hi) for m, lo, hi in base.mel_banks),
        stem=8,
        blocks=tuple(
            (max(8, f // 8), 1, k, s, min(e, 2), fused)
            for f, _r, k, s, e, fused in base.blocks
        ),
        head_features=64,
        embedding_dim=base.embedding_dim, num_classes=base.num_classes,
        activation=base.activation, frontend=base.frontend,
    )


@dataclass
class BuiltGraph:
    """A synthesized graph plus its accounting."""

    spec: GraphSpec
    model_bytes: bytes
    param_count: int
    #: MACs for one segment through the graph (x2 for FLOPs).
    macs: int
    frames: int


class _Builder:
    """Emits ONNX nodes/initializers with seeded weights and MAC accounting."""

    def __init__(self, seed: int, stats_only: bool = False):
        self.seed = seed
        #: stats_only skips weight materialization/encoding — param/MAC
        #: accounting without paying for 500 MB of random numbers.
        self.stats_only = stats_only
        self.nodes: list[bytes] = []
        self.inits: list[bytes] = []
        self.counter = 0
        self.param_count = 0
        self.macs = 0

    def _rng(self, name: str) -> np.random.Generator:
        return np.random.default_rng(
            (zlib.crc32(name.encode()) ^ (self.seed * 2654435761)) & 0xFFFFFFFF
        )

    def fresh(self, tag: str) -> str:
        self.counter += 1
        return f"{tag}_{self.counter}"

    def init(self, tag: str, arr: np.ndarray, count: bool = True) -> str:
        name = self.fresh(tag)
        arr = np.asarray(arr)
        if not self.stats_only:
            self.inits.append(E.tensor(name, arr))
        if count:
            self.param_count += int(arr.size)
        return name

    def weight(self, tag: str, shape, fan_in: int, gain: float = 1.0) -> str:
        name = self.fresh(tag)
        self.param_count += int(np.prod(shape))
        if not self.stats_only:
            arr = self._rng(name).standard_normal(shape, dtype=np.float32)
            arr *= np.float32(gain * (1.0 / max(fan_in, 1)) ** 0.5)
            self.inits.append(E.tensor(name, arr))
        return name

    def add(self, op: str, inputs, attrs=(), n_out: int = 1, out=None):
        outs = [out] if out else [self.fresh(op.lower()) for _ in range(n_out)]
        if out and n_out != 1:
            raise ValueError("explicit out only for single-output nodes")
        self.nodes.append(E.node(op, inputs, outs, name=outs[0], attrs=list(attrs)))
        return outs[0] if n_out == 1 else outs

    # -- composite layers -----------------------------------------------------

    def conv(self, x, in_ch, out_ch, k, s, hw, groups=1, bias=False, tag="conv"):
        """NCHW Conv; returns (out_name, new_hw)."""
        fan_in = (in_ch // groups) * k * k
        w = self.weight(f"{tag}_w", (out_ch, in_ch // groups, k, k), fan_in)
        ins = [x, w]
        if bias:
            ins.append(self.init(f"{tag}_b", np.zeros(out_ch, np.float32)))
        pad = k // 2
        out_hw = (-(-hw[0] // s), -(-hw[1] // s))
        self.macs += fan_in * out_ch * out_hw[0] * out_hw[1]
        y = self.add("Conv", ins, attrs=[
            E.attr_ints("strides", [s, s]),
            E.attr_ints("pads", [pad, pad, pad, pad]),
            E.attr_ints("kernel_shape", [k, k]),
            E.attr_int("group", groups),
        ])
        return y, out_hw

    def bn(self, x, ch, tag="bn"):
        r = self._rng(self.fresh(f"{tag}_stats"))
        scale = self.init(f"{tag}_s", r.uniform(0.8, 1.2, ch).astype(np.float32))
        bias = self.init(f"{tag}_b", r.normal(0, 0.05, ch).astype(np.float32))
        mean = self.init(f"{tag}_m", r.normal(0, 0.05, ch).astype(np.float32))
        var = self.init(f"{tag}_v", r.uniform(0.8, 1.2, ch).astype(np.float32))
        return self.add("BatchNormalization", [x, scale, bias, mean, var],
                        attrs=[E.attr_float("epsilon", 1e-3)])

    def swish(self, x):
        return self.add("Mul", [x, self.add("Sigmoid", [x])])

    def se(self, x, ch, se_ch, hw):
        s = self.add("GlobalAveragePool", [x])
        s, _ = self.conv(s, ch, se_ch, 1, 1, (1, 1), bias=True, tag="se_reduce")
        s = self.swish(s)
        s, _ = self.conv(s, se_ch, ch, 1, 1, (1, 1), bias=True, tag="se_expand")
        s = self.add("Sigmoid", [s])
        return self.add("Mul", [x, s])

    def mbconv(self, x, in_ch, out_ch, k, s, expand, hw, se_ratio=0.25):
        mid = in_ch * expand
        h = x
        if expand != 1:
            h, _ = self.conv(h, in_ch, mid, 1, 1, hw, tag="expand")
            h = self.swish(self.bn(h, mid))
        h, hw = self.conv(h, mid, mid, k, s, hw, groups=mid, tag="dw")
        h = self.swish(self.bn(h, mid))
        if se_ratio > 0:
            h = self.se(h, mid, max(1, int(in_ch * se_ratio)), hw)
        h, _ = self.conv(h, mid, out_ch, 1, 1, hw, tag="project")
        h = self.bn(h, out_ch)
        if s == 1 and in_ch == out_ch:
            h = self.add("Add", [h, x])
        return h, hw

    def fused_mbconv(self, x, in_ch, out_ch, k, s, expand, hw):
        mid = in_ch * expand
        if expand != 1:
            h, hw = self.conv(x, in_ch, mid, k, s, hw, tag="fused_expand")
            h = self.swish(self.bn(h, mid))
            h, _ = self.conv(h, mid, out_ch, 1, 1, hw, tag="project")
            h = self.bn(h, out_ch)
        else:
            h, hw = self.conv(x, in_ch, out_ch, k, s, hw, tag="fused")
            h = self.bn(h, out_ch)
        if s == 1 and in_ch == out_ch:
            h = self.add("Add", [h, x])
        return h, hw

    def scalar(self, tag: str, v: float) -> str:
        return self.init(tag, np.float32(v), count=False)


def _frontend(b: _Builder, spec: GraphSpec):
    """waveform [B,S] -> normalized image [B,1,T,sum(mels)]; returns name, T."""
    n_fft, hop = spec.n_fft, spec.hop
    bins = n_fft // 2 + 1
    frames = 1 + (spec.sample_count - n_fft) // hop
    win = hann(n_fft).astype(np.float32)

    u = b.add("Unsqueeze", ["waveform"], attrs=[E.attr_ints("axes", [1])])

    if spec.frontend == "conv1d_stft":
        # Windowed DFT as one strided Conv1d over [B,1,S]: out channels =
        # [cos bank ; -sin bank] (the v3.0 "STFT replaced by an equivalent
        # Conv1d" form, manifest graph.notes).
        k = np.arange(bins)[None, :]
        n = np.arange(n_fft)[:, None]
        ang = 2 * np.pi * n * k / n_fft
        cos_b = (np.cos(ang) * win[:, None]).astype(np.float32)  # [n_fft,bins]
        sin_b = (-np.sin(ang) * win[:, None]).astype(np.float32)
        stft_w = np.concatenate([cos_b.T, sin_b.T], 0)[:, None, :]  # [2b,1,n_fft]
        wname = b.init("stft_w", np.ascontiguousarray(stft_w))
        b.macs += 2 * bins * n_fft * frames
        c = b.add("Conv", [u, wname], attrs=[
            E.attr_ints("strides", [hop]),
            E.attr_ints("pads", [0, 0]),
            E.attr_ints("kernel_shape", [n_fft]),
        ])  # [B, 2*bins, T]
        re = b.add("Slice", [c], attrs=[
            E.attr_ints("starts", [0]), E.attr_ints("ends", [bins]),
            E.attr_ints("axes", [1]),
        ])
        im = b.add("Slice", [c], attrs=[
            E.attr_ints("starts", [bins]), E.attr_ints("ends", [2 * bins]),
            E.attr_ints("axes", [1]),
        ])
        power = b.add("Add", [b.add("Mul", [re, re]), b.add("Mul", [im, im])])
        spec_t = b.add("Transpose", [power],
                       attrs=[E.attr_ints("perm", [0, 2, 1])])  # [B,T,bins]
    else:
        # with-DFT form: frame via a strided identity Conv1d, window, then
        # the ONNX DFT op (the op that makes the real Perch graph
        # ORT/CUDA-only per the manifest backend notes).
        eye = np.eye(n_fft, dtype=np.float32)[:, None, :]
        fname = b.init("framer_w", eye, count=False)
        b.macs += n_fft * n_fft * frames
        c = b.add("Conv", [u, fname], attrs=[
            E.attr_ints("strides", [hop]),
            E.attr_ints("pads", [0, 0]),
            E.attr_ints("kernel_shape", [n_fft]),
        ])  # [B, n_fft, T]
        ft = b.add("Transpose", [c], attrs=[E.attr_ints("perm", [0, 2, 1])])
        wname = b.init("window", win, count=False)
        wx = b.add("Mul", [ft, wname])  # [B,T,n_fft]
        d = b.add("DFT", [wx], attrs=[
            E.attr_int("axis", 2), E.attr_int("onesided", 1),
        ])  # [B,T,bins,2]
        re = b.add("Squeeze", [b.add("Slice", [d], attrs=[
            E.attr_ints("starts", [0]), E.attr_ints("ends", [1]),
            E.attr_ints("axes", [3]),
        ])], attrs=[E.attr_ints("axes", [3])])
        im = b.add("Squeeze", [b.add("Slice", [d], attrs=[
            E.attr_ints("starts", [1]), E.attr_ints("ends", [2]),
            E.attr_ints("axes", [3]),
        ])], attrs=[E.attr_ints("axes", [3])])
        spec_t = b.add("Add", [b.add("Mul", [re, re]), b.add("Mul", [im, im])])

    mels = []
    for n_mels, fmin, fmax in spec.mel_banks:
        fb = mel_filterbank(
            n_mels, n_fft, spec.sample_rate, fmin, fmax
        ).astype(np.float32)
        fb_name = b.init("mel_fb", fb, count=False)
        b.macs += bins * n_mels * frames
        mels.append(b.add("MatMul", [spec_t, fb_name]))
    mel = mels[0] if len(mels) == 1 else b.add(
        "Concat", mels, attrs=[E.attr_int("axis", 2)]
    )

    lg = b.add("Log", [b.add("Add", [mel, b.scalar("log_eps", 1e-6)])])
    # Per-sample standardization over (time, mel) — the normalization the
    # real graphs bake in ahead of the conv stem.
    mu = b.add("ReduceMean", [lg], attrs=[
        E.attr_ints("axes", [1, 2]), E.attr_int("keepdims", 1),
    ])
    d0 = b.add("Sub", [lg, mu])
    var = b.add("ReduceMean", [b.add("Mul", [d0, d0])], attrs=[
        E.attr_ints("axes", [1, 2]), E.attr_int("keepdims", 1),
    ])
    sd = b.add("Sqrt", [b.add("Add", [var, b.scalar("std_eps", 1e-6)])])
    z = b.add("Div", [d0, sd])
    img = b.add("Unsqueeze", [z], attrs=[E.attr_ints("axes", [1])])
    return img, frames


def build(spec: GraphSpec, seed: int = 0, stats_only: bool = False) -> BuiltGraph:
    """Synthesize the ONNX bytes for ``spec`` with seeded random weights.

    ``stats_only=True`` returns empty ``model_bytes`` but exact
    ``param_count``/``macs`` accounting (for budget tests).
    """
    b = _Builder(seed, stats_only=stats_only)
    img, frames = _frontend(b, spec)
    n_mels_total = sum(m for m, _, _ in spec.mel_banks)

    hw = (frames, n_mels_total)
    x, hw = b.conv(img, 1, spec.stem, 3, 2, hw, tag="stem")
    x = b.swish(b.bn(x, spec.stem))
    in_ch = spec.stem
    for features, repeats, k, s, expand, fused in spec.blocks:
        for i in range(repeats):
            stride = s if i == 0 else 1
            if fused:
                x, hw = b.fused_mbconv(x, in_ch, features, k, stride, expand, hw)
            else:
                x, hw = b.mbconv(x, in_ch, features, k, stride, expand, hw)
            in_ch = features
    x, hw = b.conv(x, in_ch, spec.head_features, 1, 1, hw, tag="head")
    x = b.swish(b.bn(x, spec.head_features))
    x = b.add("GlobalAveragePool", [x])
    x = b.add("Flatten", [x], attrs=[E.attr_int("axis", 1)])

    # Head gains >1 compensate for the variance shrink of global average
    # pooling over uncorrelated random features, spreading the synthetic
    # scores across (0,1) the way trained heads do.
    w_emb = b.weight("emb_w", (spec.head_features, spec.embedding_dim),
                     spec.head_features, gain=4.0)
    b_emb = b.init("emb_b", np.zeros(spec.embedding_dim, np.float32))
    b.macs += spec.head_features * spec.embedding_dim
    emb_pre = b.add("Gemm", [x, w_emb, b_emb])
    emb = b.add("Mul", [emb_pre, b.add("Sigmoid", [emb_pre])],
                out="embeddings")

    w_cls = b.weight("cls_w", (spec.embedding_dim, spec.num_classes),
                     spec.embedding_dim, gain=4.0)
    b_cls = b.init("cls_b", np.zeros(spec.num_classes, np.float32))
    b.macs += spec.embedding_dim * spec.num_classes
    logits = b.add("Gemm", [emb, w_cls, b_cls])
    act = "Softmax" if spec.activation == "softmax" else "Sigmoid"
    b.add(act, [logits], out="predictions")

    model_bytes = b"" if stats_only else E.model(
        b.nodes,
        inputs=[E.value_info("waveform", ["batch", spec.sample_count])],
        outputs=[
            E.value_info("predictions", ["batch", spec.num_classes]),
            E.value_info("embeddings", ["batch", spec.embedding_dim]),
        ],
        initializers=b.inits,
        opset=17,
        graph_name=spec.name,
    )
    return BuiltGraph(
        spec=spec, model_bytes=model_bytes,
        param_count=b.param_count, macs=b.macs, frames=frames,
    )


def cached_build(spec: GraphSpec, seed: int = 0) -> BuiltGraph:
    """Like :func:`build` but memoized on disk (500 MB graphs take ~2 min to
    synthesize; benches shouldn't pay that per run). Atomic write, same
    temp+rename discipline as the registry installer."""
    import os
    import tempfile

    from ..config.paths import cache_dir

    d = cache_dir() / "fixtures"
    path = d / f"{spec.name}-s{seed}-v1.onnx"
    stats = build(spec, seed=seed, stats_only=True)
    if path.exists():
        data = path.read_bytes()
        return BuiltGraph(spec=spec, model_bytes=data,
                          param_count=stats.param_count, macs=stats.macs,
                          frames=stats.frames)
    g = build(spec, seed=seed)
    d.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(g.model_bytes)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return g
