"""Model I/O contracts (SURVEY §2.2; reference ``registry.json`` +
``manifests/*.models.json`` + ``birdnet-onnx`` crate types).

Every model family the framework runs is described by a :class:`ModelConfig`:
the sample-rate/segment contract its input must satisfy and the output heads
it produces. These contracts are data the framework must reproduce exactly —
they gate segmentation, resampling, batching, and label projection.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional


class ScoreActivation(str, Enum):
    """Final activation over class logits."""

    SIGMOID = "sigmoid"  # BirdNET v2.4 / v3.0, geomodel, bat heads
    SOFTMAX = "softmax"  # Perch v2 — region-slicing shifts scores, so slicing
    #                      must happen BEFORE the softmax renormalizes


class ModelFamily(str, Enum):
    BIRDNET_V24 = "birdnet-v24"
    BIRDNET_V30 = "birdnet-v30"
    PERCH_V2 = "perch-v2"
    BSG_FI_V44 = "bsg-fi-v44"
    GEOMODEL = "geomodel"
    BAT = "bat"
    CUSTOM = "custom"


@dataclass(frozen=True)
class ModelConfig:
    """Input/output contract for one classifier graph.

    Mirrors the reference's ``ModelConfig {sample_rate, segment_duration,
    sample_count}`` plus the output-head facts the pipeline needs.
    """

    family: ModelFamily
    sample_rate: int           # Hz the graph expects
    segment_duration: float    # seconds per segment
    sample_count: int          # exact f32 samples per segment
    num_classes: int
    activation: ScoreActivation
    embedding_dim: Optional[int] = None  # None = graph exposes no embeddings
    supports_batch_context: bool = True  # donated-buffer inference contexts
    supports_range_filter: bool = True   # geomodel projection applies
    dynamic_batch: bool = True

    def __post_init__(self):
        expected = round(self.sample_rate * self.segment_duration)
        if self.sample_count != expected:
            raise ValueError(
                f"sample_count {self.sample_count} != rate*duration {expected}"
            )


# ---------------------------------------------------------------------------
# The five shipped contracts (SURVEY §2.2 table)
# ---------------------------------------------------------------------------

#: BirdNET v2.4: 48 kHz, 3 s, [batch,144000] -> 6,522 sigmoid + 1024-d emb.
BIRDNET_V24 = ModelConfig(
    family=ModelFamily.BIRDNET_V24,
    sample_rate=48_000,
    segment_duration=3.0,
    sample_count=144_000,
    num_classes=6_522,
    activation=ScoreActivation.SIGMOID,
    embedding_dim=1_024,
)

#: BirdNET v3.0 (preview3.1): 32 kHz, 5 s, [batch,160000] ->
#: predictions [batch,11560] sigmoid + embeddings [batch,1280].
BIRDNET_V30 = ModelConfig(
    family=ModelFamily.BIRDNET_V30,
    sample_rate=32_000,
    segment_duration=5.0,
    sample_count=160_000,
    num_classes=11_560,
    activation=ScoreActivation.SIGMOID,
    embedding_dim=1_280,
)

#: Perch v2: 32 kHz, 5 s, softmax scores over 14,795 classes (incl. FSD50K
#: sound classes). No batch-context support in the reference
#: (src/pipeline/processor.rs:593-599).
PERCH_V2 = ModelConfig(
    family=ModelFamily.PERCH_V2,
    sample_rate=32_000,
    segment_duration=5.0,
    sample_count=160_000,
    num_classes=14_795,
    activation=ScoreActivation.SOFTMAX,
    embedding_dim=1_536,
    supports_batch_context=False,
)

#: BSG Finnish Birds v4.4 rides the BirdNET v2.4 backbone contract and adds
#: per-species calibration + optional SDM post-processing.
BSG_FI_V44 = ModelConfig(
    family=ModelFamily.BSG_FI_V44,
    sample_rate=48_000,
    segment_duration=3.0,
    sample_count=144_000,
    num_classes=6_522,
    activation=ScoreActivation.SIGMOID,
    embedding_dim=1_024,
)

#: BirdNET Geomodel v3.0.2 range filter: [batch,3] (lat, lon, week-encoding)
#: -> 12,012 sigmoid occurrence scores. Not an audio model; expressed with a
#: degenerate audio contract and consumed only via RangeFilter.
GEOMODEL_NUM_CLASSES = 12_012
GEOMODEL_INPUT_DIM = 3

#: BattyBirdNET regional heads: 1,024-d BirdNET v2.4 embeddings -> 11-38
#: bat species. Window contract comes from constants.bat (the slow-down trick).
BAT_EMBEDDING_DIM = 1_024


_BY_FAMILY = {
    ModelFamily.BIRDNET_V24: BIRDNET_V24,
    ModelFamily.BIRDNET_V30: BIRDNET_V30,
    ModelFamily.PERCH_V2: PERCH_V2,
    ModelFamily.BSG_FI_V44: BSG_FI_V44,
}


def contract_for(family: ModelFamily | str) -> ModelConfig:
    fam = ModelFamily(family)
    try:
        return _BY_FAMILY[fam]
    except KeyError:
        raise KeyError(f"no shipped contract for model family {fam}") from None


@dataclass(frozen=True)
class SegmentContract:
    """Windowing parameters derived from a model contract + user overlap.

    ``step = segment - overlap`` at the source rate; the tail window is
    zero-padded to the full segment (reference ``src/audio/decode.rs:150``).
    """

    sample_rate: int
    segment_duration: float
    overlap: float

    @property
    def step(self) -> float:
        return self.segment_duration - self.overlap

    def segment_samples(self, source_rate: int) -> int:
        return round(self.segment_duration * source_rate)

    def step_samples(self, source_rate: int) -> int:
        return max(1, round(self.step * source_rate))

    def estimate_segments(self, duration_secs: float) -> int:
        """Number of windows a file of this duration yields (>= 1 windows
        starting before the end of audio)."""
        if duration_secs <= 0:
            return 0
        import math

        return max(1, math.ceil((duration_secs - self.segment_duration) / self.step) + 1
                   if duration_secs > self.segment_duration else 1)
