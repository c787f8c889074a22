"""Processing pipeline configuration (reference ``src/pipeline/config.rs``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .coordinator import OutputFormat


@dataclass
class ProcessingConfig:
    """Everything ``process_file`` needs for one audio file."""

    input_path: Path
    output_dir: Path
    formats: list[OutputFormat]
    min_confidence: float
    overlap: float
    batch_size: int
    csv_columns: list[str] = field(default_factory=list)
    progress_enabled: bool = False
    csv_bom_enabled: bool = True
    model_name: str = ""
    #: (lat, lon, week) for JSON output metadata when range filtering.
    range_filter_params: Optional[tuple[float, float, int]] = None
    #: (lat, lon, day_of_year-or-None) for BSG SDM; a None day auto-detects
    #: from the file's mtime per file (reference processor.rs:476-495).
    bsg_params: Optional[tuple[float, float, Optional[int]]] = None
    #: BsgPostProcessor when the model carries BSG companion files:
    #: calibration always, SDM when bsg_params resolve.
    bsg_processor: object = None
    reporter: object = None
    #: Separate sink for progress events only (human-mode bars); detection
    #: streaming and file-write gating follow ``reporter``.
    progress_reporter: object = None
    dual_output_mode: bool = False
    #: Secondary embedding->species head (bat two-stage).
    custom_classifier: object = None
    #: Bat audio mode: no resample, bat window contract.
    bat_mode: bool = False
    #: Hard override of the watchdog timeout (tests).
    watchdog_timeout: Optional[float] = None
    #: Chunked int16 device windowing (the high-throughput path); False
    #: falls back to per-segment f32 batches.
    use_chunk_runner: bool = True
    #: Decode workers for ONE file (seek-based span decoding). 1 = the
    #: reference's single decode thread; >1 parallelizes HOT LOOP A.
    decode_workers: int = 1
