"""int8 recall-validation protocol: the port of
``birda_tpu/onnx/int8_accuracy.py``.

Given fp32 scores and int8 scores for the same segments, it computes the
metrics a recall-level decision on ``--precision int8`` needs and applies
documented acceptance criteria:

- **per-species score deltas** — mean and max |int8 − fp32| per class,
  plus the worst offenders by mean delta (a per-species calibration bias
  shows up here long before it moves top-1);
- **top-1 / top-5 agreement** — fraction of segments whose argmax
  (resp. top-5 set) is unchanged;
- **threshold-crossing counts** — at each detection threshold, how many
  (segment, species) scores cross in either direction: ``int8_only``
  are spurious detections, ``fp32_only`` are MISSED detections — the
  recall currency of a detector.

Acceptance criteria (defaults; override per deployment):

- top-1 agreement ≥ 0.98, top-5 Jaccard ≥ 0.95;
- missed-detection rate at the default threshold (fp32-only crossings /
  fp32 detections) ≤ 1%;
- spurious-detection rate (int8-only / fp32 detections) ≤ 2%;
- worst per-species mean |Δ| ≤ 0.02.

The report types and :func:`compare_scores` are numpy, the JAX package's
as they are; :func:`evaluate_model` scores through the port's lowering on
the device of the inputs it is given.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

#: Default detection thresholds to audit crossings at (the middle one is
#: ``constants.DEFAULT_MIN_CONFIDENCE``).
DEFAULT_THRESHOLDS = (0.05, 0.1, 0.25, 0.5)


@dataclass(frozen=True)
class CrossingCounts:
    """Detections (score ≥ threshold) disagreeing between precisions."""

    threshold: float
    both: int        #: detected by fp32 AND int8
    fp32_only: int   #: MISSED by int8 (the recall loss)
    int8_only: int   #: spurious int8 detections

    @property
    def missed_rate(self) -> float:
        d = self.both + self.fp32_only
        return self.fp32_only / d if d else 0.0

    @property
    def spurious_rate(self) -> float:
        d = self.both + self.fp32_only
        return self.int8_only / d if d else 0.0


@dataclass
class Criteria:
    """Acceptance thresholds (see module docstring for rationale)."""

    min_top1_agreement: float = 0.98
    min_top5_jaccard: float = 0.95
    max_missed_rate: float = 0.01
    max_spurious_rate: float = 0.02
    max_species_mean_delta: float = 0.02
    #: Which crossing threshold the missed/spurious criteria apply at.
    decision_threshold: float = 0.1


@dataclass
class Int8AccuracyReport:
    n_segments: int
    n_classes: int
    max_abs_delta: float
    mean_abs_delta: float
    top1_agreement: float
    top5_jaccard: float
    crossings: list[CrossingCounts] = field(default_factory=list)
    #: (class index, mean |Δ|, max |Δ|) for the worst classes by mean.
    worst_species: list[tuple[int, float, float]] = field(
        default_factory=list)

    def failures(self, criteria: Criteria | None = None) -> list[str]:
        """Criteria violations, empty = accept int8 for this asset."""
        c = criteria or Criteria()
        out = []
        if self.top1_agreement < c.min_top1_agreement:
            out.append(f"top-1 agreement {self.top1_agreement:.4f} < "
                       f"{c.min_top1_agreement}")
        if self.top5_jaccard < c.min_top5_jaccard:
            out.append(f"top-5 Jaccard {self.top5_jaccard:.4f} < "
                       f"{c.min_top5_jaccard}")
        cross = next((x for x in self.crossings
                      if abs(x.threshold - c.decision_threshold) < 1e-9),
                     None)
        if cross is None:
            # The missed/spurious criteria are the recall currency this
            # protocol exists for: a report built without the decision
            # threshold must fail loudly, never silently skip the check.
            out.append(
                f"decision threshold {c.decision_threshold} has no "
                f"crossing counts in this report (computed: "
                f"{[x.threshold for x in self.crossings]}) — rebuild with "
                "compare_scores(..., thresholds=(...)) including it")
        else:
            if cross.missed_rate > c.max_missed_rate:
                out.append(
                    f"missed-detection rate {cross.missed_rate:.4f} at "
                    f"threshold {cross.threshold} > {c.max_missed_rate} "
                    f"({cross.fp32_only} of {cross.both + cross.fp32_only})")
            if cross.spurious_rate > c.max_spurious_rate:
                out.append(
                    f"spurious-detection rate {cross.spurious_rate:.4f} at "
                    f"threshold {cross.threshold} > {c.max_spurious_rate}")
        if self.worst_species and \
                self.worst_species[0][1] > c.max_species_mean_delta:
            idx, mean_d, max_d = self.worst_species[0]
            out.append(
                f"class {idx} mean |Δ| {mean_d:.4f} > "
                f"{c.max_species_mean_delta} (max {max_d:.4f})")
        return out

    def render(self, labels: list[str] | None = None) -> str:
        lines = [
            f"int8 accuracy report: {self.n_segments} segments x "
            f"{self.n_classes} classes",
            f"  |Δ| max {self.max_abs_delta:.5f}  "
            f"mean {self.mean_abs_delta:.6f}",
            f"  top-1 agreement {self.top1_agreement:.4f}   "
            f"top-5 Jaccard {self.top5_jaccard:.4f}",
        ]
        for x in self.crossings:
            lines.append(
                f"  thr {x.threshold:<5}: both {x.both}  "
                f"missed {x.fp32_only} ({x.missed_rate:.2%})  "
                f"spurious {x.int8_only} ({x.spurious_rate:.2%})")
        if self.worst_species:
            lines.append("  worst classes by mean |Δ|:")
            for idx, mean_d, max_d in self.worst_species:
                name = labels[idx] if labels and idx < len(labels) else idx
                lines.append(f"    {name}: mean {mean_d:.5f} "
                             f"max {max_d:.5f}")
        return "\n".join(lines)


def compare_scores(fp32_scores, int8_scores,
                   thresholds=DEFAULT_THRESHOLDS,
                   n_worst: int = 10) -> Int8AccuracyReport:
    """Build the report from two [N, classes] score matrices."""
    a = np.asarray(fp32_scores, np.float64)
    b = np.asarray(int8_scores, np.float64)
    if a.shape != b.shape or a.ndim != 2:
        raise ValueError(f"score shapes differ: {a.shape} vs {b.shape}")
    d = np.abs(b - a)

    top1 = float(np.mean(np.argmax(a, 1) == np.argmax(b, 1)))
    k = min(5, a.shape[1])
    ta = np.argsort(-a, axis=1)[:, :k]
    tb = np.argsort(-b, axis=1)[:, :k]
    jac = []
    for ra, rb in zip(ta, tb):
        sa, sb = set(ra.tolist()), set(rb.tolist())
        jac.append(len(sa & sb) / len(sa | sb))
    crossings = []
    for t in thresholds:
        da, db = a >= t, b >= t
        crossings.append(CrossingCounts(
            threshold=float(t),
            both=int(np.sum(da & db)),
            fp32_only=int(np.sum(da & ~db)),
            int8_only=int(np.sum(~da & db)),
        ))
    mean_per_class = d.mean(axis=0)
    max_per_class = d.max(axis=0)
    order = np.argsort(-mean_per_class)[:n_worst]
    worst = [(int(i), float(mean_per_class[i]), float(max_per_class[i]))
             for i in order]
    return Int8AccuracyReport(
        n_segments=a.shape[0], n_classes=a.shape[1],
        max_abs_delta=float(d.max()), mean_abs_delta=float(d.mean()),
        top1_agreement=top1, top5_jaccard=float(np.mean(jac)),
        crossings=crossings, worst_species=worst,
    )


def evaluate_model(model, inputs, calibration_batches=None,
                   thresholds=DEFAULT_THRESHOLDS,
                   batch: int = 64,
                   calibration_rows: int = 16) -> Int8AccuracyReport:
    """fp32-lower and int8-lower ``model``, score ``inputs`` through both,
    and compare. ``inputs`` is ``[N, ...]`` numpy (run on the CPU) or a
    tensor, whose device both runs and the calibration use.
    ``calibration_batches`` defaults to the first ``calibration_rows``
    inputs (self-calibration — the conservative floor; pass representative
    audio segments for the production number). Both functions compute at
    fp32 (TF32 off), the int8 one with its quantized nodes in int8.
    """
    import torch

    from .lowering import lower
    from .quantize import calibrate, lower_int8

    x = inputs if isinstance(inputs, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(inputs, np.float32))
    device = x.device

    def run(fn):
        params = {k: torch.from_numpy(np.require(v, requirements=["C", "W"]))
                  .to(device) for k, v in fn.params.items()}
        outs = []
        with torch.inference_mode():
            for i in range(0, x.shape[0], batch):
                o = fn(x[i:i + batch].float(), params=params)
                o = o[0] if isinstance(o, tuple) else o
                outs.append(o.float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    scores32 = run(lower(model))
    calib_in = calibration_batches
    if calib_in is None:
        calib_in = [x[:calibration_rows].float()]
    calib = calibrate(model, calib_in, device=device)
    scores8 = run(lower_int8(model, calib))
    return compare_scores(scores32, scores8, thresholds=thresholds)
