"""File coordination: skip checks, output paths, input collection.

Port of reference ``src/pipeline/coordinator.rs``: output-existence-based
resume (a file is skipped when ALL requested outputs exist, unless
``--force``), advisory-lock skip, path-traversal-sanitized output names,
and recursive input collection filtered by audio extension.
"""

from __future__ import annotations

import logging
from enum import Enum
from pathlib import Path

from ..constants import output_extensions
from ..errors import PathTraversal
from ..locking.file_lock import FileLock

logger = logging.getLogger(__name__)

AUDIO_EXTENSIONS = ("wav", "flac", "mp3", "m4a", "aac")


class OutputFormat(str, Enum):
    CSV = "csv"
    RAVEN = "raven"
    AUDACITY = "audacity"
    KALEIDOSCOPE = "kaleidoscope"
    JSON = "json"
    PARQUET = "parquet"

    @classmethod
    def _missing_(cls, value):
        # The reference parses format names case-insensitively and accepts
        # "table" as an alias for the Raven selection table
        # (config/types.rs:358-365) — every route (CLI, env, config set)
        # funnels through this constructor.
        if isinstance(value, str):
            low = value.lower()
            if low == "table":
                return cls.RAVEN
            for m in cls:
                if m.value == low:
                    return m
        return None


FORMAT_EXTENSIONS = {
    OutputFormat.CSV: output_extensions.CSV,
    OutputFormat.RAVEN: output_extensions.RAVEN,
    OutputFormat.AUDACITY: output_extensions.AUDACITY,
    OutputFormat.KALEIDOSCOPE: output_extensions.KALEIDOSCOPE,
    OutputFormat.JSON: output_extensions.JSON,
    OutputFormat.PARQUET: output_extensions.PARQUET,
}


class ProcessCheck(str, Enum):
    PROCESS = "process"
    SKIP_EXISTS = "skip_exists"
    SKIP_LOCKED = "skip_locked"


def output_dir_for(input_path: Path | str, explicit_output_dir=None) -> Path:
    if explicit_output_dir is not None:
        return Path(explicit_output_dir)
    parent = Path(input_path).parent
    return parent if str(parent) else Path(".")


def sanitize_filename(filename: str) -> str:
    """Path separators become underscores (traversal defense)."""
    return filename.replace("/", "_").replace("\\", "_")


def output_path_for(input_path: Path | str, output_dir: Path | str,
                    fmt: OutputFormat) -> Path:
    input_path = Path(input_path)
    output_dir = Path(output_dir)
    stem = input_path.stem or "output"
    safe_stem = sanitize_filename(stem)
    out = output_dir / f"{safe_stem}{FORMAT_EXTENSIONS[fmt]}"
    # Defense in depth: the join must stay inside the output directory.
    try:
        out.resolve().relative_to(output_dir.resolve())
    except ValueError:
        raise PathTraversal(str(input_path)) from None
    return out


def should_process(
    input_path: Path | str,
    output_dir: Path | str,
    formats: list[OutputFormat],
    force: bool = False,
    stdout_mode: bool = False,
) -> ProcessCheck:
    if FileLock.is_locked(input_path, output_dir):
        return ProcessCheck.SKIP_LOCKED
    if stdout_mode:
        return ProcessCheck.PROCESS
    # `all` over an empty list is vacuously true (reference #339 fix): only
    # skip when at least one format was actually requested.
    if not force and formats:
        def exists(fmt):
            try:
                return output_path_for(input_path, output_dir, fmt).exists()
            except PathTraversal as e:
                logger.warning("Failed to generate output path: %s", e)
                return False

        if all(exists(f) for f in formats):
            return ProcessCheck.SKIP_EXISTS
    return ProcessCheck.PROCESS


def is_audio_file(path: Path) -> bool:
    ext = path.suffix.lstrip(".").lower()
    return ext in AUDIO_EXTENSIONS


def collect_input_files(paths: list[Path | str]) -> list[Path]:
    """Files + recursive directory walk, audio extensions only, sorted walk
    order within directories for determinism."""
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_file():
            if is_audio_file(p):
                files.append(p)
        elif p.is_dir():
            _collect_recursive(p, files)
        else:
            logger.warning("Skipping non-existent path: %s", p)
    return files


def _collect_recursive(directory: Path, files: list[Path]) -> None:
    for entry in sorted(directory.iterdir()):
        if entry.is_dir():
            _collect_recursive(entry, files)
        elif is_audio_file(entry):
            files.append(entry)
