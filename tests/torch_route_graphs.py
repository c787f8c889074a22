"""Spectrogram front-end graphs at the geometries that decide which route
the port's evaluator takes for a front-end node: the hand-written kernel
(``ops/stft_conv.py::conv1d_stft``, ``fused_logmel``) where it can hold the
geometry, the JAX package's composed route where it cannot.

Two graph forms, each written as ONNX with random weights from a seed:

- :func:`conv_graph`: an unfused Conv1d-STFT, ``x [batch, 1, S]`` -> one
  single-channel strided ``Conv`` with a bias -> ``y [batch, C, T]``;
- :func:`frontend_graph`: the Conv1d-STFT log-mel chain of
  ``fullscale._frontend`` (``waveform [batch, S]`` -> Unsqueeze -> the
  Hann-windowed DFT conv -> re/im Slices -> power -> Transpose -> one
  MatMul per mel bank -> Concat -> ``Add(eps)`` -> Log ``[batch, T, M]``),
  which the bf16 route fuses into one ``BirdaFusedMelFrontend`` node.

:data:`CASES` names each geometry with the route the card takes there:
the shipped ones (v2.4, v3.0, Perch v2's framer) on the kernel; four whose
span of 128 frames or mel width the kernels once could not hold, now on
the kernel in fewer frames per block or two mel passes (librosa's default
STFT at hop 512, a non-overlapping framer at hop 1024, a fused front end
at hop 640 and one of two 160-mel banks); a conv whose window of 80,000
samples outgrows a block's shared memory, on the kernel with its span
streamed in pieces (the JAX package's VMEM budget holds there); and one
the JAX package's kernel does not take either, a conv of one window of
76,800 samples, on the composed route. It imports numpy and the port's own modules
only, so that a machine without jax can build the graphs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from birda_tpu_torch.onnx import encode as E
from birda_tpu_torch.ops.melspec import hann, mel_filterbank

#: The front end's log offset (fullscale's ``log_eps``).
EPS = 1e-6


@dataclass(frozen=True)
class RouteCase:
    """One geometry: ``form`` "conv" (unfused Conv1d-STFT, ``channels``
    outputs) or "frontend" (the fused log-mel chain, DFT of ``k`` with
    ``banks`` of mels at ``sample_rate``), ``s`` samples at ``hop``, and
    the route the card takes."""

    name: str
    form: str
    s: int
    k: int
    hop: int
    route: str
    channels: int = 0
    banks: tuple = ()
    sample_rate: int = 32_000

    @property
    def mels(self) -> int:
        return sum(m for m, _, _ in self.banks)

    @property
    def c(self) -> int:
        return self.channels if self.form == "conv" else 2 * (self.k // 2 + 1)

    @property
    def kernel(self) -> str:
        return "conv1d_stft" if self.form == "conv" else "fused_logmel"


CASES = [
    RouteCase("v24_frontend", "frontend", 144_000, 2048, 278, "kernel",
              banks=((96, 0.0, 3000.0), (96, 500.0, 15_000.0)),
              sample_rate=48_000),
    RouteCase("v30_frontend", "frontend", 160_000, 1024, 320, "kernel",
              banks=((128, 50.0, 16_000.0),)),
    RouteCase("perch_framer", "conv", 160_000, 640, 320, "kernel",
              channels=640),
    RouteCase("conv_hop512", "conv", 144_000, 2048, 512, "kernel",
              channels=2050),
    RouteCase("conv_hop1024", "conv", 160_000, 1024, 1024, "kernel",
              channels=1026),
    RouteCase("frontend_hop640", "frontend", 160_000, 1280, 640, "kernel",
              banks=((128, 50.0, 16_000.0),)),
    RouteCase("frontend_320_mels", "frontend", 160_000, 1024, 320,
              "kernel",
              banks=((160, 0.0, 8000.0), (160, 500.0, 16_000.0))),
    RouteCase("conv_window_80000", "conv", 160_000, 80_000, 10_000,
              "kernel", channels=2),
    RouteCase("conv_window_76800", "conv", 160_000, 76_800, 76_800,
              "composed", channels=4),
]

BY_NAME = {c.name: c for c in CASES}


def conv_graph(s: int, k: int, hop: int, c: int, seed: int = 0) -> bytes:
    """``x [batch, 1, s]`` -> ``Conv(w [c, 1, k], b [c], strides=[hop])``
    -> ``y [batch, c, T]``, weights N(0, 1/k), bias N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(0, 1, (c, 1, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(0, 0.1, c).astype(np.float32)
    t = (s - k) // hop + 1
    return E.model(
        [E.node("Conv", ["x", "w", "b"], ["y"], name="conv", attrs=[
            E.attr_ints("strides", [hop]), E.attr_ints("pads", [0, 0]),
            E.attr_ints("kernel_shape", [k])])],
        inputs=[E.value_info("x", ["batch", 1, s])],
        outputs=[E.value_info("y", ["batch", c, t])],
        initializers=[E.tensor("w", w), E.tensor("b", b)])


def frontend_graph(s: int, n_fft: int, hop: int, banks, sample_rate: int
                   ) -> bytes:
    """The Conv1d-STFT log-mel chain of ``fullscale._frontend`` ending at
    its Log: ``waveform [batch, s]`` -> ``logmel [batch, T, sum(mels)]``."""
    bins = n_fft // 2 + 1
    t = (s - n_fft) // hop + 1
    win = hann(n_fft).astype(np.float32)
    kk = np.arange(bins)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2 * np.pi * n * kk / n_fft
    cos_b = (np.cos(ang) * win[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * win[:, None]).astype(np.float32)
    w = np.ascontiguousarray(
        np.concatenate([cos_b.T, sin_b.T], 0)[:, None, :])
    inits = [E.tensor("stft_w", w),
             E.tensor("log_eps", np.float32(EPS))]
    nodes = [
        E.node("Unsqueeze", ["waveform"], ["u"], name="u",
               attrs=[E.attr_ints("axes", [1])]),
        E.node("Conv", ["u", "stft_w"], ["c"], name="stft", attrs=[
            E.attr_ints("strides", [hop]), E.attr_ints("pads", [0, 0]),
            E.attr_ints("kernel_shape", [n_fft])]),
        E.node("Slice", ["c"], ["re"], name="re", attrs=[
            E.attr_ints("starts", [0]), E.attr_ints("ends", [bins]),
            E.attr_ints("axes", [1])]),
        E.node("Slice", ["c"], ["im"], name="im", attrs=[
            E.attr_ints("starts", [bins]), E.attr_ints("ends", [2 * bins]),
            E.attr_ints("axes", [1])]),
        E.node("Mul", ["re", "re"], ["re2"], name="re2"),
        E.node("Mul", ["im", "im"], ["im2"], name="im2"),
        E.node("Add", ["re2", "im2"], ["power"], name="power"),
        E.node("Transpose", ["power"], ["spec"], name="spec",
               attrs=[E.attr_ints("perm", [0, 2, 1])]),
    ]
    mels = []
    for i, (n_mels, fmin, fmax) in enumerate(banks):
        fb = mel_filterbank(n_mels, n_fft, sample_rate, fmin, fmax) \
            .astype(np.float32)
        inits.append(E.tensor(f"mel_fb_{i}", fb))
        nodes.append(E.node("MatMul", ["spec", f"mel_fb_{i}"], [f"mel_{i}"],
                            name=f"mel_{i}"))
        mels.append(f"mel_{i}")
    if len(mels) > 1:
        nodes.append(E.node("Concat", mels, ["mel"], name="mel",
                            attrs=[E.attr_int("axis", 2)]))
    else:
        nodes[-1] = E.node("MatMul", ["spec", "mel_fb_0"], ["mel"],
                           name="mel")
    nodes += [E.node("Add", ["mel", "log_eps"], ["mel_eps"], name="mel_eps"),
              E.node("Log", ["mel_eps"], ["logmel"], name="logmel")]
    m = sum(b[0] for b in banks)
    return E.model(nodes, inputs=[E.value_info("waveform", ["batch", s])],
                   outputs=[E.value_info("logmel", ["batch", t, m])],
                   initializers=inits)


def build(case: RouteCase, s: int | None = None, seed: int = 0) -> bytes:
    """The case's graph at ``s`` samples (its own by default)."""
    s = case.s if s is None else s
    if case.form == "conv":
        return conv_graph(s, case.k, case.hop, case.channels, seed)
    return frontend_graph(s, case.k, case.hop, case.banks, case.sample_rate)


def inputs(case: RouteCase, batch: int, s: int | None = None,
           seed: int = 0) -> np.ndarray:
    """A seeded signal of the graph's input shape, float32."""
    s = case.s if s is None else s
    x = np.random.default_rng(seed).normal(0, 0.1, (batch, s)) \
        .astype(np.float32)
    return x[:, None, :] if case.form == "conv" else x
