"""EfficientNet-style audio classifier backbone: the port of
``birda_tpu/models/backbone.py`` (flax linen) as ``torch.nn`` modules.

The native architecture behind the ``synthetic:`` model paths: the mel
front-end (:mod:`birda_tpu_torch.ops.melspec`), per-sample
standardization, an MBConv / fused-MBConv backbone, global pooling, an
embedding head and a class head. Stock PyTorch throughout (cuDNN convs,
cuBLAS products): the JAX module is XLA, with no Pallas kernel.

Each module takes the flax modules' ``dtype`` (default float32): the
parameters stay float32, each conv and dense casts its input and weights to
``dtype`` and computes there, each BatchNorm computes in float32 (its
statistics are float32, as flax promotes them) and returns ``dtype``, and
the classifier casts its standardized input to ``dtype`` at the stem. Where
a block adds a float32 input to a ``dtype`` output, torch's promotion gives
float32, as jnp's does. With float32 every cast is the identity.

Each module registers its children under flax's own names (``ClassName_i``
counted per class inside each parent, and the named ``embedding`` and
``classifier`` heads) and its tensors under flax's leaf names, so a
``state_dict`` key is the flax path of the leaf (``MBConv_3.ConvBNAct_1.
BatchNorm_0.mean`` is ``batch_stats/MBConv_3/ConvBNAct_1/BatchNorm_0/mean``).
Layouts are PyTorch's: the module runs NCHW with H = frames and W = mels
(flax runs NHWC), and a conv kernel is OIHW (flax: HWIO); a dense kernel
keeps flax's ``[in, out]``. :func:`flax_leaves` maps between the two.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.melspec import MelSpecConfig, melspec

#: flax.linen.BatchNorm's default epsilon.
BN_EPSILON = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``padding="SAME"`` along one axis: the output is
    ``ceil(size / stride)`` long and the total pad goes ``total // 2`` low,
    the rest high (so an even input at kernel 3, stride 2 pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _Flax(nn.Module):
    """A module whose children are named as flax's compact auto-naming
    names them: ``ClassName_i``, counted per class inside this parent."""

    def _child(self, module: nn.Module, name: str | None = None):
        if name is None:
            counts = self.__dict__.setdefault("_flax_counts", {})
            kind = type(module).__name__
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
        self.add_module(name, module)
        return module


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``padding="SAME"``: ``kernel`` [out, in/groups,
    kh, kw] (flax: [kh, kw, in/groups, out]) and an optional ``bias``."""

    def __init__(self, cin: int, features: int, kernel=(3, 3), strides=(1, 1),
                 groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides = tuple(strides)
        self.groups = groups
        self.dtype = dtype
        self.register_buffer(
            "kernel", torch.zeros(features, cin // groups, *kernel))
        if bias:
            self.register_buffer("bias", torch.zeros(features))
        else:
            self.bias = None

    def forward(self, x):
        kh, kw = self.kernel.shape[2:]
        (t, b), (l, r) = (same_pads(x.shape[2], kh, self.strides[0]),
                          same_pads(x.shape[3], kw, self.strides[1]))
        x = x.to(self.dtype)
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.kernel.to(self.dtype), bias, self.strides,
                        groups=self.groups)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)`` over channels, in
    flax's order: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, in
    float32 (the float32 statistics promote ``x``), out as ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for name in ("scale", "bias", "mean", "var"):
            self.register_buffer(name, torch.zeros(features))

    def forward(self, x):
        def c(v):
            return v.reshape(1, -1, 1, 1)

        mul = torch.rsqrt(c(self.var) + BN_EPSILON) * c(self.scale)
        return ((x - c(self.mean)) * mul + c(self.bias)).to(self.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` [in, out] and ``bias`` [out]."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel", torch.zeros(cin, features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x):
        return (torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
                + self.bias.to(self.dtype))


class ConvBNAct(_Flax):
    """Conv (no bias) -> BatchNorm -> swish (SiLU) unless ``act=False``."""

    def __init__(self, cin: int, features: int, kernel=(3, 3), strides=(1, 1),
                 groups: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self._child(Conv(cin, features, kernel, strides, groups, bias=False,
                         dtype=dtype))
        self._child(BatchNorm(features, dtype))

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.silu(x) if self.act else x


class SqueezeExcite(_Flax):
    def __init__(self, features: int, se_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self._child(Conv(features, se_features, (1, 1), dtype=dtype))
        self._child(Conv(se_features, features, (1, 1), dtype=dtype))

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.Conv_1(F.silu(self.Conv_0(s)))
        return x * torch.sigmoid(s)


class MBConv(_Flax):
    """1x1 expand (when ``expand != 1``) -> depthwise ``kernel`` at
    ``strides`` -> squeeze-excite -> 1x1 project, residual when shapes
    allow."""

    def __init__(self, cin: int, features: int, expand: int, kernel, strides,
                 se_ratio: float = 0.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = cin * expand
        self.residual = tuple(strides) == (1, 1) and cin == features
        layers = []
        if expand != 1:
            layers.append(self._child(ConvBNAct(cin, mid, (1, 1),
                                                dtype=dtype)))
        layers.append(self._child(ConvBNAct(mid, mid, kernel, strides,
                                            groups=mid, dtype=dtype)))
        if se_ratio > 0:
            layers.append(self._child(SqueezeExcite(
                mid, max(1, int(cin * se_ratio)), dtype)))
        layers.append(self._child(ConvBNAct(mid, features, (1, 1),
                                            act=False, dtype=dtype)))
        self.layers = layers

    def forward(self, x):
        h = x
        for layer in self.layers:
            h = layer(h)
        return h + x if self.residual else h


class FusedMBConv(_Flax):
    """EfficientNetV2-style fused block: one full ``kernel`` expand conv
    (then a 1x1 project) in place of 1x1-expand + depthwise."""

    def __init__(self, cin: int, features: int, expand: int, kernel, strides,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = cin * expand
        self.residual = tuple(strides) == (1, 1) and cin == features
        if expand != 1:
            self.layers = [
                self._child(ConvBNAct(cin, mid, kernel, strides, dtype=dtype)),
                self._child(ConvBNAct(mid, features, (1, 1), act=False,
                                      dtype=dtype)),
            ]
        else:
            self.layers = [self._child(ConvBNAct(cin, features, kernel,
                                                 strides, act=False,
                                                 dtype=dtype))]

    def forward(self, x):
        h = x
        for layer in self.layers:
            h = layer(h)
        return h + x if self.residual else h


#: (features, repeats, kernel, strides, expand, fused) block table —
#: EfficientNetV2-style: fused blocks at high spatial resolution, MBConv+SE
#: once maps are small.
DEFAULT_BLOCKS: Sequence[tuple[int, int, int, int, int, bool]] = (
    (16, 1, 3, 1, 1, True),
    (24, 2, 3, 2, 4, True),
    (40, 2, 3, 2, 4, True),
    (80, 3, 3, 2, 4, False),
    (112, 3, 5, 1, 6, False),
    (192, 4, 5, 2, 6, False),
    (320, 1, 3, 1, 6, False),
)


class AudioClassifier(_Flax):
    """Waveform -> (class scores, embeddings).

    Input: ``[batch, sample_count]`` float32 at the model's sample rate, or
    precomputed mel ``[batch, frames, mels]`` (the chunk runner's hop-grid
    front-end). Output dict: ``scores`` [batch, num_classes] after
    sigmoid/softmax, ``logits`` and ``embeddings`` [batch, embedding_dim],
    all float32 at any ``dtype``.
    """

    def __init__(self, mel: MelSpecConfig, num_classes: int,
                 embedding_dim: int, activation: str = "sigmoid",
                 blocks=DEFAULT_BLOCKS, stem_features: int = 32,
                 head_features: int = 1280,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mel = mel
        self.activation = activation
        self.dtype = dtype
        layers = [self._child(ConvBNAct(1, stem_features, (3, 3), (2, 2),
                                        dtype=dtype))]
        cin = stem_features
        for spec in blocks:
            features, repeats, k, s, expand = spec[:5]
            fused = spec[5] if len(spec) > 5 else False
            block = FusedMBConv if fused else MBConv
            for i in range(repeats):
                strides = (s, s) if i == 0 else (1, 1)
                layers.append(self._child(block(cin, features, expand,
                                                (k, k), strides,
                                                dtype=dtype)))
                cin = features
        layers.append(self._child(ConvBNAct(cin, head_features, (1, 1),
                                            dtype=dtype)))
        self.layers = layers
        self._child(Dense(head_features, embedding_dim, dtype), "embedding")
        self._child(Dense(embedding_dim, num_classes, dtype), "classifier")

    def forward(self, waveform):
        x = waveform if waveform.ndim == 3 else melspec(waveform, self.mel)
        # Per-sample standardization; jnp.std is the population std.
        mu = x.mean(dim=(1, 2), keepdim=True)
        sd = x.std(dim=(1, 2), keepdim=True, correction=0) + 1e-6
        # NCHW, H = frames, W = mels, cast at the stem as in flax.
        x = ((x - mu) / sd)[:, None].to(self.dtype)
        for layer in self.layers:
            x = layer(x)
        x = x.mean(dim=(2, 3))  # global average pool
        emb = F.silu(self.embedding(x))
        logits = self.classifier(emb).float()
        if self.activation == "softmax":
            scores = torch.softmax(logits, dim=-1)
        else:
            scores = torch.sigmoid(logits)
        return {"scores": scores, "logits": logits,
                "embeddings": emb.float()}


def flax_leaves(module: nn.Module) -> list[tuple[str, tuple, torch.Tensor]]:
    """Every leaf of ``module`` as ``(flax path, flax shape, tensor)``, the
    path as ``jax.tree_util`` spells it for a flax variables tree
    (``params/.../kernel``; running statistics under ``batch_stats``)."""
    out = []
    for name, t in module.state_dict(keep_vars=True).items():
        leaf = name.rsplit(".", 1)[-1]
        coll = "batch_stats" if leaf in ("mean", "var") else "params"
        shape = tuple(t.shape)
        if t.ndim == 4:  # a conv kernel: OIHW here, HWIO in flax
            shape = (shape[2], shape[3], shape[1], shape[0])
        out.append(("/".join([coll, *name.split(".")]), shape, t))
    return out


def load_flax_leaf(t: torch.Tensor, arr: np.ndarray) -> None:
    """Write a flax-layout array into the module tensor ``t`` in place."""
    src = torch.from_numpy(np.array(arr, np.float32))  # a writable copy
    if t.ndim == 4:
        src = src.permute(3, 2, 0, 1)
    if tuple(src.shape) != tuple(t.shape):
        raise ValueError(f"leaf of shape {tuple(arr.shape)} does not fit "
                         f"{tuple(t.shape)}")
    t.copy_(src)
