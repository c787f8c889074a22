"""Application-wide constants.

Every magic number and string lives here so the three configuration routes
(CLI flag, ``BIRDA_*`` env var, config.toml) share one source of truth.

TPU-native rebuild of the reference constant table (reference:
``src/constants.rs`` — batch bounds :29-40, EP batch defaults :43-58,
coordinates :91-113, output extensions :200-212, range-filter calendar
:249-285, bat contract :453-470).
"""

from __future__ import annotations

APP_NAME = "birda"

# ---------------------------------------------------------------------------
# Detection / inference defaults
# ---------------------------------------------------------------------------

DEFAULT_MIN_CONFIDENCE = 0.1
DEFAULT_OVERLAP = 0.0
DEFAULT_SENSITIVITY = 1.0
DEFAULT_TOP_K = 5

# Batch size bounds (reference src/constants.rs:29-40). One segment is the
# smallest meaningful batch; the ceiling guards HBM exhaustion from absurd
# requests, and per-file effective batch is capped to the segment estimate.
DEFAULT_BATCH_SIZE = 8
MIN_BATCH_SIZE = 1
MAX_BATCH_SIZE = 512


class batch_size:
    """Batch-size defaults by backend and model family.

    Mirrors reference ``src/constants.rs:43-58``; the CUDA/TensorRT tiers map
    onto the TPU backend, where large batches keep the MXU fed.
    """

    CPU = DEFAULT_BATCH_SIZE
    # TPU defaults: big batches amortize host->HBM transfer and fill the MXU.
    # Measured sweet spots on a v5e with the ONNX-lowered full-scale
    # graphs, bf16 activations (docs/performance.md batch scaling).
    TPU_BIRDNET_V24 = 256
    TPU_BIRDNET_V30 = 256
    TPU_PERCH_V2 = 256
    OTHER_ACCEL = 16


class sensitivity:
    """Sigmoid sensitivity scaling bounds (BirdNET convention)."""

    MIN = 0.5
    MAX = 1.5


class day_of_year:
    """1-based calendar position; 366 so the last day of a leap year is
    reachable (reference src/constants.rs:63-75)."""

    MIN = 1
    MAX = 366


class time:
    SECONDS_PER_MINUTE = 60
    SECONDS_PER_HOUR = 60 * SECONDS_PER_MINUTE
    SECONDS_PER_DAY = 24 * SECONDS_PER_HOUR


class coordinates:
    """Geographic bounds shared by CLI validators, config validation, and
    error messages (reference src/constants.rs:91-113)."""

    LATITUDE_MIN = -90.0
    LATITUDE_MAX = 90.0
    LONGITUDE_MIN = -180.0
    LONGITUDE_MAX = 180.0


class parquet:
    """Columns every Parquet file carries before the optional metadata ones."""

    BASE_FIELD_COUNT = 6
    ROW_GROUP_SIZE = 1000
    COMPRESSION = "snappy"


class csv_columns:
    """Every name ``defaults.csv_columns.include`` accepts
    (reference src/constants.rs:131-160)."""

    RECOGNISED = (
        "lat",
        "lon",
        "week",
        "model",
        "overlap",
        "sensitivity",
        "min_conf",
        "species_list",
    )


LOCK_FILE_EXTENSION = ".birda.lock"


class config_lock:
    """Exclusive lock serialising config read-modify-write
    (reference src/constants.rs:168-196)."""

    LOCK_SUFFIX = ".birda.lock"
    ACQUIRE_TIMEOUT_SECS = 5.0
    RETRY_INTERVAL_SECS = 0.05


class output_extensions:
    CSV = ".BirdNET.results.csv"
    RAVEN = ".BirdNET.selection.table.txt"
    AUDACITY = ".BirdNET.results.txt"
    KALEIDOSCOPE = ".BirdNET.results.kaleidoscope.csv"
    JSON = ".BirdNET.json"
    PARQUET = ".BirdNET.results.parquet"


class combined_filenames:
    CSV = "BirdNET_CombinedTable.csv"
    RAVEN = "BirdNET_SelectionTable.txt"
    KALEIDOSCOPE = "BirdNET_Kaleidoscope.csv"
    PARQUET = "BirdNET_CombinedTable.parquet"


class confidence:
    MIN = 0.0
    MAX = 1.0
    DECIMAL_PLACES = 4


class raven:
    VIEW = "Spectrogram 1"
    CHANNEL = 1
    DEFAULT_LOW_FREQ = 150
    DEFAULT_HIGH_FREQ = 15000


class range_filter:
    """BirdNET 48-week calendar + geomodel contract
    (reference src/constants.rs:249-285)."""

    WEEK_MIN = 1
    WEEKS_PER_YEAR = 48
    DAYS_PER_WEEK = 7.6  # 365.25 / 48
    YEAR_START_DAY = 1.0
    DEFAULT_THRESHOLD = 0.01
    GEOMODEL_VERSION = "3.0.2"
    GEOMODEL_SPECIES_COUNT = 12_012
    # Query the geomodel at threshold 0 so every class gets a score; policy
    # thresholding happens afterwards in the classifier's own label space.
    GEOMODEL_QUERY_THRESHOLD = 0.0


class species_list_cmd:
    """Defaults for the ``species`` subcommand (reference src/cli/species.rs)."""

    DEFAULT_THRESHOLD = 0.03


class download:
    PARTIAL_SUFFIX = "part"
    CONNECT_TIMEOUT_SECS = 30
    REQUEST_TIMEOUT_MINS = 5
    CONNECTIVITY_PROBE_TIMEOUT_SECS = 5
    HUGGING_FACE_ENDPOINT = "https://huggingface.co"
    HF_ENDPOINT_ENV = "HF_ENDPOINT"


class obsolete_files:
    NAMES = ("birdnet-v24-meta.onnx",)


class calendar:
    DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
    MONTH_MIN = 1
    MONTH_MAX = 12
    DAY_MIN = 1
    DAY_MAX = 31


assert len(calendar.DAYS_IN_MONTH) == calendar.MONTH_MAX
assert max(calendar.DAYS_IN_MONTH) == calendar.DAY_MAX

UTF8_BOM = b"\xef\xbb\xbf"


class compile_cache:
    """XLA persistent compilation cache (the TPU analogue of the reference's
    TensorRT engine cache, src/constants.rs:368-371). Warmup reporting uses
    BUILD_THRESHOLD_SECS to tell a fresh compile from a cache load."""

    CACHE_DIR = "xla_cache"
    BUILD_THRESHOLD_SECS = 2.0


class clipper:
    DEFAULT_PRE_PADDING = 5.0
    DEFAULT_POST_PADDING = 5.0
    MAX_PADDING = 300.0
    DEFAULT_OUTPUT_DIR = "clips"
    SEEK_THRESHOLD_SECS = 10.0
    BIRDNET_RESULTS_SUFFIX = ".BirdNET.results"
    BIRDNET_SUFFIX = ".BirdNET"
    AUDIO_EXTENSIONS = ("wav", "flac", "mp3", "m4a", "aac")
    MAX_CLIP_PREALLOC_SECS = 60
    MAX_SKIPPED_ROW_WARNINGS = 10


class bat:
    """BattyBirdNET "slow-down trick": 144,000 samples at 256 kHz through the
    48 kHz BirdNET v2.4 backbone (reference src/constants.rs:453-470)."""

    SAMPLE_RATE = 256_000
    CHUNK_SAMPLES = 144_000
    SEGMENT_DURATION = CHUNK_SAMPLES / SAMPLE_RATE  # 0.5625 s
    OVERLAP_FRACTION = 0.25
    OVERLAP = SEGMENT_DURATION * OVERLAP_FRACTION


# Absolute ceiling on a clip reservation whatever the container claims its
# sample rate to be (reference src/constants.rs:430-441).
clipper.MAX_CLIP_PREALLOC_SAMPLES = clipper.MAX_CLIP_PREALLOC_SECS * bat.SAMPLE_RATE


class audio:
    """Audio front-end constants."""

    SUPPORTED_EXTENSIONS = ("wav", "flac", "mp3", "m4a", "aac", "ogg", "opus")
    # Bounded decode->device queue: 2 batches in flight gives backpressure
    # without starving the accelerator (reference src/pipeline/processor.rs:638).
    QUEUE_BATCH_CAPACITY = 2
    # Decode workers feeding the device queue. The reference's single decode
    # thread is its documented scaling ceiling (SURVEY §3.1); the TPU pipeline
    # fans out decode across workers per file set.
    DEFAULT_DECODE_WORKERS = 4


class watchdog:
    """Inference watchdog: hard-exit if one batch wedges the accelerator
    (reference src/gpu/watchdog.rs:22, src/pipeline/processor.rs:194-211)."""

    DEFAULT_TIMEOUT_SECS = 10
    MIN_TIMEOUT_SECS = 1
    MAX_TIMEOUT_SECS = 3600
    TIMEOUT_ENV = "BIRDA_INFERENCE_TIMEOUT"


class backend:
    """Accelerator backend identifiers (the TPU analogue of the reference's
    12-provider ladder, src/inference/classifier.rs:662-921)."""

    TPU = "tpu"
    CPU = "cpu"
    AUTO = "auto"
    ALL = (TPU, CPU)


class json_protocol:
    """NDJSON event envelope spec (reference src/output/json_envelope.rs:11)."""

    SPEC_VERSION = "1.1"


class stale_lock:
    """--stale-lock-timeout parsing bounds."""

    DEFAULT = None  # disabled unless the user opts in
