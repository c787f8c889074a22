"""Error taxonomy.

One exception hierarchy mirroring the reference's single ~90-variant error
enum (reference ``src/error.rs:8``): every failure mode has a typed class with
the offending path/reason embedded, and the cause chain is preserved so the
CLI can print a deduplicated cause list (reference ``src/main.rs:43-52``).

Python idiom: instead of one enum we use a class tree rooted at
:class:`BirdaError`, grouped by subsystem. ``str(err)`` is the user-facing
message; ``err.__cause__`` carries the chain.
"""

from __future__ import annotations


class BirdaError(Exception):
    """Base class for every birda failure."""

    def cause_chain(self) -> list[str]:
        """Deduplicated list of messages down the ``__cause__`` chain."""
        seen: list[str] = []
        err: BaseException | None = self
        while err is not None:
            msg = str(err)
            # Wrapper messages embed their cause ("failed to X: <cause>");
            # re-printing the embedded cause as its own line is noise.
            if msg and not any(msg in prior for prior in seen):
                seen.append(msg)
            err = err.__cause__
        return seen


def _mk(name: str, base: type, fmt: str | None = None) -> type:
    """Build an error class with an optional ``{field}`` message template."""

    def __init__(self, *args, **kwargs):  # noqa: N807
        if fmt is not None:
            try:
                msg = fmt.format(*args, **kwargs)
            except (IndexError, KeyError):
                msg = (fmt + " " + " ".join(str(a) for a in args)).strip()
            Exception.__init__(self, msg)
            self.args_raw = args
            self.kwargs_raw = kwargs
        else:
            Exception.__init__(self, *args)

    cls = type(name, (base,), {"__init__": __init__, "__doc__": fmt or name})
    return cls


# ---------------------------------------------------------------------------
# Subsystem bases
# ---------------------------------------------------------------------------

class AudioError(BirdaError):
    """Audio decode / resample / segmentation failures."""


class InferenceError(BirdaError):
    """Model build / predict / backend failures."""


class ConfigError(BirdaError):
    """Config load / parse / validation failures."""


class RegistryError(BirdaError):
    """Model registry / install / download failures."""


class OutputError(BirdaError):
    """Detection writer failures."""


class LockError(BirdaError):
    """Advisory file-lock failures."""


class ClipperError(BirdaError):
    """Clip extraction failures."""


class UpdateError(BirdaError):
    """Self-update failures."""


class ValidationError(BirdaError):
    """User-input validation failures (CLI / env / config routes)."""


# ---------------------------------------------------------------------------
# Audio (reference variants: AudioOpen, AudioDecode, Resample, NoAudioTracks,
# UnsupportedAudioFormat, DecodeChannelClosed, NoValidAudioFiles)
# ---------------------------------------------------------------------------

AudioOpen = _mk("AudioOpen", AudioError, "failed to open audio file {0}: {1}")
AudioDecode = _mk("AudioDecode", AudioError, "failed to decode audio from {0}: {1}")
ResampleError = _mk("ResampleError", AudioError, "resampling failed: {0}")
NoAudioTracks = _mk("NoAudioTracks", AudioError, "no audio tracks found in {0}")
UnsupportedAudioFormat = _mk(
    "UnsupportedAudioFormat", AudioError, "unsupported audio format: {0}"
)
DecodeChannelClosed = _mk(
    "DecodeChannelClosed", AudioError,
    "decode worker exited before the file was fully read",
)
NoValidAudioFiles = _mk(
    "NoValidAudioFiles", AudioError, "no valid audio files found in the input set"
)

# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

RuntimeInitialization = _mk(
    "RuntimeInitialization", InferenceError,
    "accelerator runtime initialization failed: {0}",
)
ClassifierBuild = _mk("ClassifierBuild", InferenceError, "failed to build classifier: {0}")
Inference = _mk("Inference", InferenceError, "inference failed: {0}")
ModelFileNotFound = _mk("ModelFileNotFound", InferenceError, "model file not found: {0}")
LabelLoad = _mk("LabelLoad", InferenceError, "failed to load labels from {0}: {1}")
LabelsFileNotFound = _mk("LabelsFileNotFound", InferenceError, "labels file not found: {0}")
InvalidModelType = _mk("InvalidModelType", InferenceError, "invalid model type: {0}")
OnnxExternalData = _mk(
    "OnnxExternalData", InferenceError,
    "ONNX external weight data unavailable for tensor '{0}': {1}",
)
OnnxGraphUnsupported = _mk(
    "OnnxGraphUnsupported", InferenceError,
    "ONNX graph is not fully supported — {0} issue(s):\n{1}",
)
RangeFilterBuild = _mk(
    "RangeFilterBuild", InferenceError, "failed to build range filter: {0}"
)
RangeFilterPredict = _mk(
    "RangeFilterPredict", InferenceError, "range filter prediction failed: {0}"
)
RangeFilterAssetMissing = _mk(
    "RangeFilterAssetMissing", InferenceError, "range filter asset missing: {0}"
)
GeomodelNotInstalled = _mk(
    "GeomodelNotInstalled", InferenceError,
    "the BirdNET Geomodel is not installed; run 'birda models install "
    "geomodel' to enable range filtering",
)
GeomodelLabelCount = _mk(
    "GeomodelLabelCount", InferenceError,
    "geomodel label count mismatch: expected {0}, found {1}",
)
GeomodelPathsIncomplete = _mk(
    "GeomodelPathsIncomplete", InferenceError,
    "geomodel configuration is incomplete: {0}",
)
BsgConfig = _mk("BsgConfig", InferenceError, "BSG configuration error: {0}")
BsgCalibration = _mk("BsgCalibration", InferenceError, "BSG calibration load failed: {0}")
BsgMigration = _mk("BsgMigration", InferenceError, "BSG migration data load failed: {0}")
BsgDistributionMaps = _mk(
    "BsgDistributionMaps", InferenceError, "BSG distribution maps load failed: {0}"
)

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

ConfigRead = _mk("ConfigRead", ConfigError, "failed to read config {0}: {1}")
ConfigParse = _mk("ConfigParse", ConfigError, "failed to parse config {0}: {1}")
ConfigWrite = _mk("ConfigWrite", ConfigError, "failed to write config {0}: {1}")
ConfigSerialize = _mk("ConfigSerialize", ConfigError, "failed to serialize config: {0}")
ConfigValidation = _mk("ConfigValidation", ConfigError, "invalid configuration: {0}")
ConfigLocked = _mk(
    "ConfigLocked", ConfigError,
    "config file is locked by another birda process (waited {0:.1f}s)",
)
ConfigDirNotFound = _mk(
    "ConfigDirNotFound", ConfigError, "could not determine the config directory"
)
CacheDirNotFound = _mk(
    "CacheDirNotFound", ConfigError, "could not determine the cache directory"
)
InvalidConfigKey = _mk("InvalidConfigKey", ConfigError, "unknown config key: {0}")

# ---------------------------------------------------------------------------
# Validation (shared by CLI / env / config routes)
# ---------------------------------------------------------------------------

InvalidConfidence = _mk(
    "InvalidConfidence", ValidationError,
    "confidence must be between 0.0 and 1.0, got {0}",
)
InvalidLatitude = _mk(
    "InvalidLatitude", ValidationError,
    "latitude must be between -90.0 and 90.0, got {0}",
)
InvalidLongitude = _mk(
    "InvalidLongitude", ValidationError,
    "longitude must be between -180.0 and 180.0, got {0}",
)
InvalidRangeThreshold = _mk(
    "InvalidRangeThreshold", ValidationError,
    "range filter threshold must be between 0.0 and 1.0, got {0}",
)
InvalidOutputFormat = _mk(
    "InvalidOutputFormat", ValidationError, "invalid output format: {0}"
)
InvalidColumnName = _mk("InvalidColumnName", ValidationError, "invalid column name: {0}")
InvalidTimeRange = _mk("InvalidTimeRange", ValidationError, "invalid time range: {0}")
InvalidPadding = _mk("InvalidPadding", ValidationError, "invalid padding: {0}")
DayOfYearAutoDetect = _mk(
    "DayOfYearAutoDetect", ValidationError,
    "could not auto-detect day of year from file modification time: {0}",
)
PathTraversal = _mk(
    "PathTraversal", ValidationError,
    "output path for {0} would escape the output directory",
)

# ---------------------------------------------------------------------------
# Registry / install / download
# ---------------------------------------------------------------------------

RegistryRead = _mk("RegistryRead", RegistryError, "failed to read registry {0}: {1}")
RegistryParse = _mk("RegistryParse", RegistryError, "failed to parse registry: {0}")
RegistryWrite = _mk("RegistryWrite", RegistryError, "failed to write registry {0}: {1}")
RegistrySerialize = _mk(
    "RegistrySerialize", RegistryError, "failed to serialize registry: {0}"
)
ModelNotFound = _mk("ModelNotFound", RegistryError, "model not found: {0}")
ModelNotFoundInRegistry = _mk(
    "ModelNotFoundInRegistry", RegistryError, "model not found in registry: {0}"
)
ModelAlreadyExists = _mk(
    "ModelAlreadyExists", RegistryError, "model already exists: {0}"
)
ModelHasNoLanguages = _mk(
    "ModelHasNoLanguages", RegistryError,
    "model {0} has no label language variants (variant families ship one "
    "English labels file per region)"
)
LanguageNotFound = _mk(
    "LanguageNotFound", RegistryError, "language {0} not available for model {1}"
)
VariantNotFound = _mk("VariantNotFound", RegistryError, "variant not found: {0}")
RegionNotFound = _mk("RegionNotFound", RegistryError, "region not found: {0}")
RegionsNotSupported = _mk(
    "RegionsNotSupported", RegistryError, "model {0} has no regional variants"
)
DownloadFailed = _mk("DownloadFailed", RegistryError, "download failed for {0}: {1}")
DownloadInstallFailed = _mk(
    "DownloadInstallFailed", RegistryError, "failed to install downloaded file {0}: {1}"
)
NoNetworkConnectivity = _mk(
    "NoNetworkConnectivity", RegistryError,
    "no network connectivity; cannot download {0}",
)
FileDeletionFailed = _mk(
    "FileDeletionFailed", RegistryError, "failed to delete {0}: {1}"
)

# ---------------------------------------------------------------------------
# Output
# ---------------------------------------------------------------------------

OutputDirCreateFailed = _mk(
    "OutputDirCreateFailed", OutputError, "failed to create output directory {0}: {1}"
)
JsonWrite = _mk("JsonWrite", OutputError, "failed to write JSON output: {0}")
JsonFlush = _mk("JsonFlush", OutputError, "failed to flush JSON output: {0}")
ParquetFileCreate = _mk(
    "ParquetFileCreate", OutputError, "failed to create parquet file {0}: {1}"
)
ParquetFileOpen = _mk(
    "ParquetFileOpen", OutputError, "failed to open parquet file {0}: {1}"
)
ParquetWrite = _mk("ParquetWrite", OutputError, "parquet write failed: {0}")
NoInputFilesToCombine = _mk(
    "NoInputFilesToCombine", OutputError, "no input files to combine"
)
SpeciesListRead = _mk(
    "SpeciesListRead", OutputError, "failed to read species list {0}: {1}"
)
SpeciesListWrite = _mk(
    "SpeciesListWrite", OutputError, "failed to write species list {0}: {1}"
)

# ---------------------------------------------------------------------------
# Locking
# ---------------------------------------------------------------------------

FileLocked = _mk("FileLocked", LockError, "file is locked by another process: {0}")
LockCreate = _mk("LockCreate", LockError, "failed to create lock file {0}: {1}")
LockRemove = _mk("LockRemove", LockError, "failed to remove lock file {0}: {1}")

# ---------------------------------------------------------------------------
# Clipper
# ---------------------------------------------------------------------------

DetectionParseFailed = _mk(
    "DetectionParseFailed", ClipperError, "failed to parse detection file {0}: {1}"
)
InvalidDetectionFormat = _mk(
    "InvalidDetectionFormat", ClipperError, "unrecognised detection file format: {0}"
)
SourceAudioNotFound = _mk(
    "SourceAudioNotFound", ClipperError, "source audio not found for {0}"
)
EmptyExtraction = _mk(
    "EmptyExtraction", ClipperError, "extraction produced no samples for {0}"
)
ClipFileProducedNothing = _mk(
    "ClipFileProducedNothing", ClipperError,
    "no clips extracted from '{0}': all {1} detection(s) failed"
)
ClipBatchAllFailed = _mk(
    "ClipBatchAllFailed", ClipperError, "all detection files failed to produce clips"
)
WavWriteFailed = _mk("WavWriteFailed", ClipperError, "failed to write WAV {0}: {1}")

# ---------------------------------------------------------------------------
# Self-update
# ---------------------------------------------------------------------------

UpdateFetchFailed = _mk(
    "UpdateFetchFailed", UpdateError, "failed to fetch update manifest: {0}"
)
UpdateManifestParse = _mk(
    "UpdateManifestParse", UpdateError, "failed to parse update manifest: {0}"
)
UpdateChecksumMismatch = _mk(
    "UpdateChecksumMismatch", UpdateError,
    "update checksum mismatch: expected {0}, got {1}",
)
UpdateUnsupportedPlatform = _mk(
    "UpdateUnsupportedPlatform", UpdateError, "no update asset for platform {0}"
)
UpdateExtractFailed = _mk(
    "UpdateExtractFailed", UpdateError, "failed to extract update archive: {0}"
)
UpdateReplaceFailed = _mk(
    "UpdateReplaceFailed", UpdateError, "failed to replace binary: {0}"
)
UpdateExeNotFound = _mk(
    "UpdateExeNotFound", UpdateError, "could not locate the running executable"
)
UpdatePermissionDenied = _mk(
    "UpdatePermissionDenied", UpdateError, "permission denied replacing {0}"
)
UpdateDevBuild = _mk(
    "UpdateDevBuild", UpdateError, "refusing to self-update a development build"
)
UpdateBlocked = _mk("UpdateBlocked", UpdateError, "update blocked: {0}")

# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

IoError = _mk("IoError", BirdaError, "I/O error: {0}")
Internal = _mk("Internal", BirdaError, "internal error: {0}")
