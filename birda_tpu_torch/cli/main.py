"""Command line of the PyTorch/CUDA port: ``analyze`` and ``species`` on the
card.

    python -m birda_tpu_torch.cli.main analyze rec.wav -m birdnet-v24 \\
        --gpu --precision bf16 -o out/
    python -m birda_tpu_torch.cli.main species --lat 60.2 --lon 24.9 \\
        --week 20 -o species_list.txt

The options of the JAX package's ``birda analyze`` and ``birda species``
(``birda_tpu/cli/main.py``), with the same meaning, validation, conflict
rules and ``BIRDA_*`` environment variables: each option's variable is its
argparse default, taken from ``os.environ`` and passed through the same
validator as the flag, so a flag on the command line wins over the
variable. The other subcommands (config, models, clip, update) are not
ported yet. Built on :mod:`argparse`, so the port needs no click.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

from . import validators as v
from ..config import file as config_file
from ..config.bat import BatRegion
from ..config.types import ModelType, OutputMode
from ..errors import BirdaError
from ..output.json_envelope import ErrorSeverity
from ..output.reporter import create_reporter
from ..pipeline.coordinator import OutputFormat

logger = logging.getLogger(__name__)

#: Spellings of a flag's variable (click's boolean parse): anything else is
#: refused; an empty or unset variable leaves the flag off.
_TRUE = ("1", "true", "t", "yes", "y", "on")
_FALSE = ("0", "false", "f", "no", "n", "off")


def _env(name: str) -> str | None:
    """The variable's value as the option's default; unset and empty are
    both "not given", as in click."""
    return os.environ.get(name) or None


def _checked(parse):
    """An argparse type from a :mod:`birda_tpu_torch.cli.validators`
    parser."""

    def convert(s):
        try:
            return parse(s)
        except v.ValidationFailure as e:
            raise argparse.ArgumentTypeError(str(e)) from e

    return convert


def _choice(values):
    """An argparse type that admits ``values``. A type rather than
    ``choices=``: argparse converts a string default through the type but
    never checks it against ``choices``."""

    def convert(s):
        if s not in values:
            raise argparse.ArgumentTypeError(
                f"'{s}' is not one of {', '.join(values)}")
        return s

    return convert


def _int_range(lo: int, hi: int):
    def convert(s):
        try:
            n = int(s)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"'{s}' is not a valid integer") from None
        if not lo <= n <= hi:
            raise argparse.ArgumentTypeError(
                f"{n} is not in the range {lo}<=x<={hi}")
        return n

    return convert


def _formats(s: str) -> list[OutputFormat]:
    out = []
    for name in s.split(","):
        name = name.strip()
        if not name:
            continue
        try:
            out.append(OutputFormat(name))
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"'{name}' is not one of "
                + ", ".join(f.value for f in OutputFormat)
                + " (or 'table' for raven)") from None
    return out


#: Flags that read a variable: (dest, variable).
_ENV_FLAGS = (("combine", "BIRDA_COMBINE"), ("no_csv_bom", "BIRDA_NO_CSV_BOM"),
              ("rerank", "BIRDA_RERANK"), ("no_progress", "BIRDA_NO_PROGRESS"))


def _flag(a, *names, env: str, **kw):
    a.add_argument(*names, action="store_true", default=_env(env), **kw)


def _add_analyze(sub) -> None:
    a = sub.add_parser("analyze",
                       help="Analyze audio files for bird detections.")
    a.add_argument("inputs", nargs="+", type=Path)
    a.add_argument("-m", "--model", default=_env("BIRDA_MODEL"),
                   help="Configured model name.")
    a.add_argument("--model-path", type=Path, default=_env("BIRDA_MODEL_PATH"),
                   help="Ad-hoc model graph path.")
    a.add_argument("--labels-path", type=Path,
                   default=_env("BIRDA_LABELS_PATH"))
    types = [t.value for t in ModelType]
    a.add_argument("--model-type", type=_choice(types),
                   default=_env("BIRDA_MODEL_TYPE"),
                   metavar="{" + ",".join(types) + "}")
    regions = [r.value for r in BatRegion]
    a.add_argument("--bat", type=_choice(regions), default=_env("BIRDA_BAT"),
                   metavar="{" + ",".join(regions) + "}",
                   help="Bat region (enables BattyBirdNET two-stage mode).")
    a.add_argument("-f", "--format", dest="formats", action="append",
                   type=_formats, default=None,
                   help="Output formats, comma-separated: "
                        + ", ".join(f.value for f in OutputFormat)
                        + " ('table' = raven).")
    a.add_argument("-o", "--output-dir", type=Path,
                   default=_env("BIRDA_OUTPUT_DIR"))
    a.add_argument("-c", "--min-confidence",
                   type=_checked(v.parse_confidence),
                   default=_env("BIRDA_MIN_CONFIDENCE"),
                   help=f"Minimum confidence {v.HELP_RANGES['confidence']}.")
    a.add_argument("--overlap", type=_checked(v.parse_overlap),
                   default=_env("BIRDA_OVERLAP"))
    a.add_argument("-b", "--batch-size", type=_checked(v.parse_batch_size),
                   default=_env("BIRDA_BATCH_SIZE"),
                   help=f"Inference batch size "
                        f"{v.HELP_RANGES['batch_size']}.")
    _flag(a, "--combine", env="BIRDA_COMBINE")
    a.add_argument("--force", action="store_true")
    a.add_argument("--fail-fast", action="store_true")
    a.add_argument("-q", "--quiet", action="store_true")
    a.add_argument("-v", "--verbose", action="count", default=0)
    _flag(a, "--no-csv-bom", env="BIRDA_NO_CSV_BOM")
    dev = a.add_mutually_exclusive_group()
    dev.add_argument("--gpu", "--cuda", dest="gpu", action="store_true",
                     help="Require a CUDA device (fail if unavailable).")
    dev.add_argument("--cpu", action="store_true", help="Force CPU.")
    a.add_argument("--lat", type=_checked(v.parse_latitude),
                   default=_env("BIRDA_LATITUDE"),
                   help=f"Latitude {v.HELP_RANGES['latitude']}.")
    a.add_argument("--lon", type=_checked(v.parse_longitude),
                   default=_env("BIRDA_LONGITUDE"),
                   help=f"Longitude {v.HELP_RANGES['longitude']}.")
    a.add_argument("--week", type=_checked(v.parse_week),
                   default=_env("BIRDA_WEEK"),
                   help=f"BirdNET calendar week {v.HELP_RANGES['week']}.")
    a.add_argument("--month", type=_checked(v.parse_month),
                   default=_env("BIRDA_MONTH"),
                   help=f"Month {v.HELP_RANGES['month']}.")
    a.add_argument("--day", type=_checked(v.parse_day),
                   default=_env("BIRDA_DAY"),
                   help=f"Day of month {v.HELP_RANGES['day']}.")
    a.add_argument("--day-of-year", type=_checked(v.parse_day_of_year),
                   default=_env("BIRDA_DAY_OF_YEAR"),
                   help=f"Day of year {v.HELP_RANGES['day_of_year']}.")
    a.add_argument("--range-threshold", type=_checked(v.parse_confidence),
                   default=_env("BIRDA_RANGE_THRESHOLD"),
                   help=f"Range-filter score threshold "
                        f"{v.HELP_RANGES['confidence']}.")
    _flag(a, "--rerank", env="BIRDA_RERANK")
    a.add_argument("--range-unmatched", type=_choice(["keep", "drop"]),
                   default=_env("BIRDA_RANGE_UNMATCHED"),
                   metavar="{keep,drop}")
    a.add_argument("--slist", type=Path, default=_env("BIRDA_SLIST"))
    a.add_argument("--stale-lock-timeout",
                   type=_checked(v.parse_stale_lock_timeout),
                   default=_env("BIRDA_STALE_LOCK_TIMEOUT"))
    a.add_argument("-j", "--jobs", type=int, default=_env("BIRDA_JOBS") or 1,
                   help="Concurrent per-file workers: one file's decode "
                        "overlaps another's inference on the card.")
    _flag(a, "--no-progress", env="BIRDA_NO_PROGRESS")
    a.add_argument("--stdout", dest="stdout_mode", action="store_true",
                   help="Stream detections to stdout; write no files.")
    a.add_argument("--output-mode", type=_choice(["human", "json", "ndjson"]),
                   default=_env("BIRDA_OUTPUT_MODE"),
                   metavar="{human,json,ndjson}")
    a.add_argument("--accept-license", action="store_true")
    a.add_argument("--decode-workers", type=_int_range(0, 64),
                   default=_env("BIRDA_DECODE_WORKERS") or 0,
                   help="Decode threads per file (0-64): 0 = auto, 1 = one.")
    a.add_argument("--devices", type=_int_range(1, 4096),
                   default=_env("BIRDA_DEVICES"),
                   help="Devices to shard each batch over (data "
                        "parallelism, one replica per device). Default: "
                        "every local CUDA device (the CPU only on an "
                        "explicit N); 1 disables sharding (also "
                        "BIRDA_NO_SHARD=1).")
    a.add_argument("--precision",
                   type=_choice(["fp32", "bf16", "mixed", "int8"]),
                   default=_env("BIRDA_PRECISION") or "fp32",
                   metavar="{fp32,bf16,mixed,int8}",
                   help="ONNX graph precision: fp32 = full fp32 (TF32 off); "
                        "bf16 = bf16 matmuls/convs with fp32 accumulation "
                        "and the fused front-end kernel; mixed = bf16 "
                        "compute with calibrated int8 storage of the large "
                        "boundary streams; int8 = calibrated int8 "
                        "quantization of the heavy matmuls/convs with int32 "
                        "accumulation (the TensorRT-int8 analogue).")
    a.add_argument("--calibration-audio", type=Path,
                   default=_env("BIRDA_CALIBRATION_AUDIO"),
                   help="Representative audio (file or directory) to "
                        "calibrate int8 activation scales on (--precision "
                        "int8/mixed); default is a built-in synthetic set "
                        "whose scales are cached per graph.")
    a.add_argument("--region-labels", type=Path,
                   default=_env("BIRDA_REGION_LABELS"),
                   help="Slice the model to this regional label file "
                        "(subset of the full labels; softmax models "
                        "renormalize).")
    a.add_argument("--profile", dest="profile_dir", type=Path,
                   default=_env("BIRDA_PROFILE"),
                   help="Write a torch.profiler Chrome trace of the run "
                        "into this directory.")
    a.add_argument("--geomodel-path", type=Path,
                   default=_env("BIRDA_GEOMODEL_PATH"),
                   help="BirdNET Geomodel v3.0.2 ONNX file (overrides "
                        "config). Must be given together with "
                        "--geomodel-labels-path.")
    a.add_argument("--geomodel-labels-path", type=Path,
                   default=_env("BIRDA_GEOMODEL_LABELS_PATH"),
                   help="Geomodel labels file. Must be given together with "
                        "--geomodel-path.")
    a.add_argument("--meta-model-path", type=Path,
                   default=_env("BIRDA_META_MODEL_PATH"),
                   help=argparse.SUPPRESS)
    a.add_argument("-y", "--yes", action="store_true",
                   help="Assume yes for prompts (geomodel download offer, "
                        "license acceptance).")


def _add_species(sub) -> None:
    s = sub.add_parser("species",
                       help="Generate a species list from the range filter.")
    s.add_argument("-o", "--output", type=Path)
    s.add_argument("--lat", type=_checked(v.parse_latitude), required=True,
                   help=f"Latitude {v.HELP_RANGES['latitude']}.")
    s.add_argument("--lon", type=_checked(v.parse_longitude), required=True,
                   help=f"Longitude {v.HELP_RANGES['longitude']}.")
    s.add_argument("--week", type=_checked(v.parse_week),
                   help=f"BirdNET calendar week {v.HELP_RANGES['week']}.")
    s.add_argument("--month", type=_checked(v.parse_month),
                   help=f"Month {v.HELP_RANGES['month']}.")
    s.add_argument("--day", type=_checked(v.parse_day),
                   help=f"Day of month {v.HELP_RANGES['day']}.")
    s.add_argument("--threshold", type=_checked(v.parse_confidence),
                   help=f"Occurrence-score threshold "
                        f"{v.HELP_RANGES['confidence']}.")
    s.add_argument("--sort", type=_choice(["freq", "alpha"]), default="freq",
                   metavar="{freq,alpha}")
    s.add_argument("-m", "--model")
    s.add_argument("--geomodel-path", type=Path,
                   default=_env("BIRDA_GEOMODEL_PATH"),
                   help="Geomodel ONNX override; requires "
                        "--geomodel-labels-path.")
    s.add_argument("--geomodel-labels-path", type=Path,
                   default=_env("BIRDA_GEOMODEL_LABELS_PATH"))
    s.add_argument("-y", "--yes", action="store_true",
                   help="Assume yes for prompts (geomodel download offer).")
    s.add_argument("--output-mode", type=_choice(["human", "json", "ndjson"]),
                   default=_env("BIRDA_OUTPUT_MODE"),
                   metavar="{human,json,ndjson}")
    dev = s.add_mutually_exclusive_group()
    dev.add_argument("--gpu", "--cuda", dest="gpu", action="store_true",
                     help="Require a CUDA device (fail if unavailable).")
    dev.add_argument("--cpu", action="store_true",
                     help="Run the geomodel on the CPU.")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m birda_tpu_torch.cli.main",
        description="birda on PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_analyze(sub)
    _add_species(sub)
    return parser


def init_logging(verbose: int, quiet: bool) -> None:
    level = (logging.WARNING if quiet
             else logging.DEBUG if verbose else logging.INFO)
    logging.basicConfig(level=level, stream=sys.stderr,
                        format="%(levelname)s %(name)s: %(message)s")


def print_error_chain(e: BirdaError) -> None:
    chain = e.cause_chain()
    sys.stderr.write(f"Error: {chain[0]}\n")
    for cause in chain[1:]:
        sys.stderr.write(f"  caused by: {cause}\n")


def _finish_analyze_args(parser, args) -> None:
    """What a default cannot express: the flags' truthy variables, the
    format variable (a flag replaces it, it does not add to it) and the
    JAX command's conflict rules."""
    for dest, name in _ENV_FLAGS:
        value = getattr(args, dest)
        if isinstance(value, str):
            if value.strip().lower() not in _TRUE + _FALSE:
                parser.error(f"{name}: {value!r} is not a valid boolean")
            setattr(args, dest, value.strip().lower() in _TRUE)
        elif value is None:
            setattr(args, dest, False)
    if args.formats is None:
        args.formats = []
        for item in (_env("BIRDA_FORMAT") or "").split():
            try:
                args.formats.append(_formats(item))
            except argparse.ArgumentTypeError as e:
                parser.error(f"BIRDA_FORMAT: {e}")
    if args.week is not None and (args.month is not None
                                  or args.day is not None):
        parser.error("--week conflicts with --month/--day")
    if (args.month is None) != (args.day is None):
        parser.error("--month and --day must be given together")
    if (args.geomodel_path is None) != (args.geomodel_labels_path is None):
        parser.error("--geomodel-path and --geomodel-labels-path must be "
                     "given together")
    if args.calibration_audio is not None and \
            args.precision not in ("int8", "mixed"):
        parser.error("--calibration-audio only applies with --precision "
                     "int8/mixed")


def analyze(args: argparse.Namespace) -> int:
    from ..config.validate import validate_config

    from ..orchestrator import AnalyzeOptions, analyze_files

    init_logging(args.verbose, args.quiet)
    formats = [f for group in args.formats for f in group]
    if args.meta_model_path is not None:
        logger.warning(
            "--meta-model-path is deprecated and ignored; range filtering "
            "uses the BirdNET Geomodel v3.0.2. Use --geomodel-path and "
            "--geomodel-labels-path to point at a specific copy.")
    if args.stdout_mode and (args.combine or args.output_dir is not None
                             or formats):
        sys.stderr.write(
            "Error: --stdout conflicts with --combine/--output-dir/--format\n")
        return 2
    try:
        config = config_file.load_default_config()
        validate_config(config)
    except BirdaError as e:
        if args.output_mode in ("json", "ndjson"):
            r = create_reporter(args.output_mode)
            r.error("config_invalid", ErrorSeverity.FATAL, str(e))
            r.finish()
        print_error_chain(e)
        return 1

    mode = (OutputMode(args.output_mode) if args.output_mode
            else config.output.default_format)
    if args.stdout_mode and not mode.is_structured:
        mode = OutputMode.NDJSON
    dual = mode.is_structured and args.output_dir is not None \
        and not args.stdout_mode
    if mode.is_structured:
        reporter = create_reporter(mode.value)
    else:
        from ..output.progress import HumanReporter

        reporter = HumanReporter(enabled=not (args.no_progress or args.quiet))

    options = AnalyzeOptions(
        inputs=list(args.inputs),
        model=args.model,
        model_path=args.model_path,
        labels_path=args.labels_path,
        model_type=ModelType(args.model_type) if args.model_type else None,
        bat=args.bat,
        formats=formats or None,
        output_dir=args.output_dir,
        min_confidence=args.min_confidence,
        overlap=args.overlap,
        batch_size=args.batch_size,
        combine=args.combine,
        force=args.force,
        fail_fast=args.fail_fast,
        no_csv_bom=args.no_csv_bom,
        device_flags={"gpu": args.gpu, "cpu": args.cpu},
        lat=args.lat, lon=args.lon, week=args.week, month=args.month,
        day=args.day, day_of_year=args.day_of_year,
        range_threshold=args.range_threshold,
        rerank=args.rerank,
        range_unmatched=args.range_unmatched,
        slist=args.slist,
        stale_lock_timeout=args.stale_lock_timeout,
        jobs=max(1, args.jobs),
        stdout_mode=args.stdout_mode,
        dual_output_mode=dual,
        allow_download=args.accept_license or args.yes,
        interactive=sys.stdin.isatty() and not mode.is_structured,
        geomodel_path=args.geomodel_path,
        geomodel_labels_path=args.geomodel_labels_path,
        region_labels=args.region_labels,
        decode_workers=args.decode_workers,
        devices=args.devices,
        precision=args.precision,
        calibration_audio=args.calibration_audio,
    )
    profiler = None
    if args.profile_dir is not None:
        profiler = _start_profile()
    try:
        code = analyze_files(options, config, reporter)
    except BirdaError as e:
        reporter.error("analysis_failed", ErrorSeverity.FATAL, str(e))
        reporter.finish()
        print_error_chain(e)
        return 1
    finally:
        if profiler is not None:
            _stop_profile(profiler, args.profile_dir)
    reporter.finish()
    return code


def _start_profile():
    """A ``torch.profiler`` run over the whole analysis (host ops, and the
    card's kernels where there is one): the counterpart of the JAX
    package's ``jax.profiler`` trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, out_dir: Path) -> None:
    prof.stop()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"birda.{os.getpid()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    logger.info("profiler trace written to %s", path)


def species(parser, args: argparse.Namespace) -> int:
    """The JAX command's ``species``: one geomodel pass, written one label
    per line (human mode) or reported inline (json/ndjson), on the card
    unless ``--cpu``."""
    from ..inference.range_filter import query_device
    from ..output import json_envelope as env
    from .species import (compute_species_list, generate_species_list,
                          split_species_label)

    if args.week is None and (args.month is None or args.day is None):
        parser.error("provide --week, or --month with --day")
    if args.week is not None and (args.month is not None
                                  or args.day is not None):
        parser.error("--week conflicts with --month/--day")
    if (args.geomodel_path is None) != (args.geomodel_labels_path is None):
        parser.error("--geomodel-path and --geomodel-labels-path must be "
                     "given together")
    structured = args.output_mode in ("json", "ndjson")
    kw = dict(lat=args.lat, lon=args.lon, week=args.week, month=args.month,
              day=args.day, threshold=args.threshold, sort=args.sort,
              model_name=args.model, geomodel_path=args.geomodel_path,
              geomodel_labels_path=args.geomodel_labels_path,
              allow_download=args.yes)
    device = "cpu" if args.cpu else "cuda" if args.gpu else "auto"
    try:
        with query_device(device):
            if structured:
                result = compute_species_list(**kw)
            else:
                path, count = generate_species_list(
                    output=args.output, interactive=sys.stdin.isatty(), **kw)
    except BirdaError as e:
        if structured:
            reporter = create_reporter(args.output_mode)
            reporter.error("species_list_failed", ErrorSeverity.FATAL, str(e))
            reporter.finish()
        print_error_chain(e)
        return 1
    if structured:
        entries = []
        for label, score in result.entries:
            sci, common = split_species_label(label)
            entries.append(env.species_entry(
                scientific_name=sci, common_name=common, frequency=score))
        reporter = create_reporter(args.output_mode)
        reporter.result(env.species_list_payload(
            lat=args.lat, lon=args.lon, week=result.week,
            threshold=result.threshold, species=entries, output_file=None))
        reporter.finish()
        return 0
    print(f"Wrote {count} species to {path}")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "species":
        return species(parser, args)
    _finish_analyze_args(parser, args)
    return analyze(args)


if __name__ == "__main__":
    sys.exit(main())
