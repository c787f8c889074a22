"""Command line of the PyTorch/CUDA port: every subcommand of the JAX
package's ``birda`` (``birda_tpu/cli/main.py``), on the card.

    python -m birda_tpu_torch.cli.main rec.wav -m birdnet-v24 --gpu \\
        --precision bf16 -o out/
    python -m birda_tpu_torch.cli.main species --lat 60.2 --lon 24.9 \\
        --week 20 -o species_list.txt
    python -m birda_tpu_torch.cli.main models add m --path m.onnx \\
        --labels labels.txt --type birdnet-v24 --default
    python -m birda_tpu_torch.cli.main clip out/rec.BirdNET.results.csv

``analyze`` (also reached as ``birda <files>``, with no subcommand word),
``species``, ``config {init,show,path,set}``, ``models {list,
list-available,add,check,info,remove,regions,install}``, ``clip``,
``update``, ``version`` and ``providers``, with the JAX commands' options,
output in the human, json and ndjson modes, typed errors and exit codes. A
global ``--output-mode`` before the subcommand reaches every subcommand
through ``BIRDA_OUTPUT_MODE``. Every option that reads a ``BIRDA_*``
variable in the JAX command reads it here: the variable is the option's
argparse default, taken from ``os.environ`` and passed through the same
validator as the flag, so a flag on the command line wins over the
variable. Built on :mod:`argparse`, so the port needs no click.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

from . import validators as v
from .. import __version__, constants
from ..config import file as config_file
from ..config import paths as config_paths
from ..config.bat import BatRegion
from ..config.types import (Config, InferenceDevice, ModelConfig, ModelType,
                            OutputMode)
from ..errors import BirdaError
from ..output import json_envelope as env
from ..output.json_envelope import ErrorSeverity
from ..output.reporter import create_reporter
from ..pipeline.coordinator import OutputFormat

logger = logging.getLogger(__name__)

SUBCOMMANDS = {
    "config", "models", "providers", "clip", "update", "species", "analyze",
    "version",
}

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


def _output_mode(p) -> None:
    p.add_argument("--output-mode", type=_choice(["human", "json", "ndjson"]),
                   default=_env("BIRDA_OUTPUT_MODE"),
                   metavar="{human,json,ndjson}")


def _add_config(sub) -> None:
    c = sub.add_parser("config", help="Manage configuration.")
    cs = c.add_subparsers(dest="config_command", required=True)
    cs.add_parser("init").set_defaults(handler=config_init)
    show = cs.add_parser("show")
    _output_mode(show)
    show.set_defaults(handler=config_show)
    path = cs.add_parser("path")
    _output_mode(path)
    path.set_defaults(handler=config_path)
    st = cs.add_parser("set", help="Set a configuration value by dotted "
                                   "path.")
    st.add_argument("key")
    st.add_argument("value")
    st.set_defaults(handler=config_set)


def _add_models(sub) -> None:
    m = sub.add_parser("models", help="Manage models.")
    ms = m.add_subparsers(dest="models_command", required=True)
    ls = ms.add_parser("list")
    _output_mode(ls)
    ls.set_defaults(handler=models_list)
    la = ms.add_parser("list-available")
    _output_mode(la)
    la.set_defaults(handler=models_list_available)
    add = ms.add_parser("add")
    add.add_argument("name")
    add.add_argument("--path", dest="path_", type=Path, required=True)
    add.add_argument("--labels", type=Path, required=True)
    types = [t.value for t in ModelType]
    add.add_argument("--type", dest="type_", type=_choice(types),
                     required=True, metavar="{" + ",".join(types) + "}")
    add.add_argument("--default", dest="set_default", action="store_true")
    add.set_defaults(handler=models_add)
    chk = ms.add_parser("check", help="Validate configured models.")
    _output_mode(chk)
    chk.add_argument("--no-graph", action="store_true",
                     help="Skip the ONNX graph preflight (file-existence "
                          "checks only).")
    chk.set_defaults(handler=models_check)
    info = ms.add_parser("info")
    info.add_argument("model_id")
    info.add_argument("--languages", action="store_true")
    _output_mode(info)
    info.set_defaults(handler=models_info)
    rm = ms.add_parser("remove")
    rm.add_argument("name")
    rm.add_argument("--purge", action="store_true")
    rm.add_argument("-y", "--yes", action="store_true",
                    help="Assume yes for the --purge confirmation prompt.")
    _output_mode(rm)
    rm.set_defaults(handler=models_remove)
    rg = ms.add_parser("regions", help="List regional tiles grouped by "
                                       "continent.")
    rg.add_argument("model_id")
    rg.set_defaults(handler=models_regions)
    ins = ms.add_parser("install")
    ins.add_argument("model_id")
    ins.add_argument("-l", "--language", default=None,
                     help="Label language code (default: the model's own "
                          "default). A language the model lacks is an "
                          "error, not a fallback.")
    ins.add_argument("--region")
    ins.add_argument("--variant")
    ins.add_argument("-d", "--default", dest="set_default",
                     action="store_true")
    ins.add_argument("--accept-license", action="store_true")
    ins.add_argument("-y", "--yes", action="store_true",
                     help="Assume yes for prompts (license acceptance).")
    _output_mode(ins)
    ins.set_defaults(handler=models_install)


def _add_clip(sub) -> None:
    c = sub.add_parser("clip",
                       help="Extract audio clips from detection results.")
    c.add_argument("files", nargs="*", type=Path)
    c.add_argument("-o", "--output", type=Path,
                   default=Path(constants.clipper.DEFAULT_OUTPUT_DIR))
    c.add_argument("--audio", type=Path,
                   help="Source audio (direct mode; auto-detected in CSV "
                        "mode).")
    c.add_argument("--base-dir", type=Path)
    c.add_argument("--pre", type=_checked(v.parse_padding),
                   default=constants.clipper.DEFAULT_PRE_PADDING)
    c.add_argument("--post", type=_checked(v.parse_padding),
                   default=constants.clipper.DEFAULT_POST_PADDING)
    c.add_argument("--confidence", type=_checked(v.parse_confidence),
                   default=0.0)
    c.add_argument("--species", dest="species_")
    c.add_argument("--start", type=_checked(v.parse_time), default=None)
    c.add_argument("--end", type=_checked(v.parse_time), default=None)
    _output_mode(c)
    c.set_defaults(handler=clip)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m birda_tpu_torch.cli.main",
        description="birda on PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_analyze(sub)
    _add_species(sub)
    _add_config(sub)
    _add_models(sub)
    _add_clip(sub)
    up = sub.add_parser("update", help="Check for and install updates.")
    up.add_argument("--check", action="store_true",
                    help="Only check, don't install.")
    up.set_defaults(handler=update)
    ver = sub.add_parser("version", help="Show the birda version.")
    _output_mode(ver)
    ver.set_defaults(handler=version)
    prov = sub.add_parser("providers",
                          help="Show available inference backends.")
    _output_mode(prov)
    prov.set_defaults(handler=providers)
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
        config = _load_validated_config()
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

    _install_sigint_cleanup(reporter, len(args.inputs))
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


def _load_validated_config() -> Config:
    """Load + validate, with validation gated so repair commands stay
    reachable with a broken file (validation runs for consumers only)."""
    from ..config.validate import validate_config

    config = config_file.load_default_config()
    for key in config.deprecated_keys():
        logger.warning("config key '%s' is deprecated and ignored", key)
    validate_config(config)
    return config


def _install_sigint_cleanup(reporter, total_files: int) -> None:
    """Ctrl+C releases every file and config lock this process holds,
    reports the cancellation and exits 130."""
    import signal

    def handler(signum, frame):
        from ..locking.config_lock import cleanup_all_config_locks
        from ..locking.file_lock import cleanup_all_locks

        removed = cleanup_all_locks() + cleanup_all_config_locks()
        if removed:
            sys.stderr.write(f"\nReleased {removed} lock(s)\n")
        reporter.cancelled(env.CancelReason.USER_INTERRUPT, 0, total_files)
        reporter.finish()
        sys.exit(130)

    try:
        signal.signal(signal.SIGINT, handler)
    except ValueError:
        pass  # not the main thread


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


# ---------------------------------------------------------------------------
# config subcommand
# ---------------------------------------------------------------------------

def _structured(mode) -> bool:
    return mode in ("json", "ndjson")


def config_init(parser, args) -> int:
    path = config_paths.config_file_path()
    if path.exists():
        print(f"Config already exists: {path}")
        return 0
    config_file.save_config(Config(), path)
    print(f"Created {path}")
    return 0


def config_show(parser, args) -> int:
    from ..utils import toml_writer

    cfg = config_file.load_default_config()
    if _structured(args.output_mode):
        reporter = create_reporter(args.output_mode)
        reporter.result(env.config_payload(
            str(config_paths.config_file_path()), cfg.to_dict()))
        reporter.finish()
        return 0
    print(toml_writer.dumps(cfg.to_dict()))
    return 0


def config_path(parser, args) -> int:
    path = config_paths.config_file_path()
    if _structured(args.output_mode):
        reporter = create_reporter(args.output_mode)
        reporter.result(env.config_path_payload(str(path), path.exists()))
        reporter.finish()
        return 0
    print(str(path))
    return 0


def config_set(parser, args) -> int:
    """Set a configuration value by dotted path."""
    try:
        config_file.update_config(
            lambda cfg: _apply_config_set(cfg, args.key, args.value))
    except BirdaError as e:
        print_error_chain(e)
        return 1
    print(f"Set {args.key} = {args.value}")
    return 0


def _apply_config_set(cfg: Config, key: str, value: str):
    from ..config.types import DefaultsConfig
    from ..errors import InvalidConfigKey

    d = cfg.defaults
    # An empty value clears the key on every arm: back to None for the
    # optional fields, back to the field default otherwise.
    empty = value == ""
    fresh = DefaultsConfig()
    try:
        if key == "defaults.model":
            d.model = None if empty else value
        elif key == "defaults.min_confidence":
            d.min_confidence = (fresh.min_confidence if empty
                                else v.parse_confidence(value))
        elif key == "defaults.overlap":
            d.overlap = fresh.overlap if empty else v.parse_overlap(value)
        elif key == "defaults.batch_size":
            d.batch_size = None if empty else v.parse_batch_size(value)
        elif key == "defaults.latitude":
            d.latitude = None if empty else v.parse_latitude(value)
        elif key == "defaults.longitude":
            d.longitude = None if empty else v.parse_longitude(value)
        elif key == "defaults.range_threshold":
            d.range_threshold = (fresh.range_threshold if empty
                                 else v.parse_confidence(value))
        elif key == "defaults.range_unmatched":
            from ..inference.geomodel_filter import UnmatchedPolicy

            d.range_unmatched = (fresh.range_unmatched if empty
                                 else UnmatchedPolicy(value))
        elif key == "defaults.day_of_year":
            d.day_of_year = None if empty else v.parse_day_of_year(value)
        elif key == "defaults.geomodel":
            d.geomodel = None if empty else Path(value)
        elif key == "defaults.geomodel_labels":
            d.geomodel_labels = None if empty else Path(value)
        elif key == "defaults.species_list_file":
            d.species_list_file = None if empty else Path(value)
        elif key == "defaults.formats":
            d.formats = (list(fresh.formats) if empty else
                         [OutputFormat(f.strip()) for f in value.split(",")])
        elif key == "inference.device":
            from ..config.types import InferenceConfig

            cfg.inference.device = (InferenceConfig().device if empty
                                    else InferenceDevice(value))
        elif key == "output.default_format":
            from ..config.types import OutputConfig

            cfg.output.default_format = (OutputConfig().default_format
                                         if empty else OutputMode(value))
        else:
            raise InvalidConfigKey(key)
    except (v.ValidationFailure, ValueError) as e:
        # ValueError covers the enum-valued keys: an unknown value is a
        # clean config error, not a traceback.
        from ..errors import ConfigValidation

        raise ConfigValidation(str(e)) from e


# ---------------------------------------------------------------------------
# models subcommand
# ---------------------------------------------------------------------------

def models_list(parser, args) -> int:
    cfg = config_file.load_default_config()
    if _structured(args.output_mode):
        reporter = create_reporter(args.output_mode)
        reporter.result(env.model_list_payload([
            env.model_entry(
                id=name, model_type=m.model_type.value,
                is_default=cfg.defaults.model == name,
                path=str(m.path), labels_path=str(m.labels))
            for name, m in cfg.models.items()]))
        reporter.finish()
        return 0
    if not cfg.models:
        print("No models configured. Run 'birda models install <id>'.")
        return 0
    for name, m in cfg.models.items():
        default = " (default)" if cfg.defaults.model == name else ""
        print(f"{name}{default}: {m.model_type.value} at {m.path}")
    return 0


def _license_line(license_info) -> str:
    """License id plus whichever restrictions apply."""
    notes = []
    if not license_info.commercial_use:
        notes.append("non-commercial")
    if license_info.share_alike:
        notes.append("share-alike")
    if not notes:
        return license_info.type
    return f"{license_info.type} ({', '.join(notes)})"


def models_list_available(parser, args) -> int:
    from ..registry.installer import GEOMODEL_INSTALL_ID
    from ..registry.loader import load_registry

    reg = load_registry()
    if _structured(args.output_mode):
        rf = None
        if reg.range_filter is not None:
            e = reg.range_filter
            sizes = (e.model.size_bytes, e.labels.size_bytes)
            rf = env.available_range_filter_entry(
                # The install handle ("geomodel"), not the asset id: it is
                # the string a user can type.
                id=GEOMODEL_INSTALL_ID, name=e.name or e.id,
                version=e.version, vendor=e.vendor, license=e.license.type,
                commercial_use=e.license.commercial_use,
                share_alike=e.license.share_alike,
                species_count=e.species_count,
                # Both files are required, so only a full sum is reported.
                size_bytes=(sum(sizes) if all(s is not None for s in sizes)
                            else None))
        reporter = create_reporter(args.output_mode)
        reporter.result(env.available_models_payload(
            models=[env.available_model_entry(
                id=m.id, name=m.name, description=m.description,
                vendor=m.vendor, version=m.version,
                model_type=m.model_type, recommended=m.recommended,
                license=m.license.type,
                commercial_use=m.license.commercial_use)
                for m in reg.models],
            available_range_filter=rf))
        reporter.finish()
        return 0
    for m in reg.models:
        rec = " [recommended]" if m.recommended else ""
        variants = f" ({len(m.variants)} variants)" if m.has_variants else ""
        print(f"{m.id}{rec}: {m.name} v{m.version}{variants}")
        print(f"    {m.description}")
        print(f"    License: {_license_line(m.license)}")
    if reg.range_filter is not None:
        # The geomodel lives in registry.range_filter, not registry.models:
        # listing it here makes the asset every error message names
        # discoverable.
        e = reg.range_filter
        print()
        print("Range filter (shared by all classifiers):")
        print(f"  {GEOMODEL_INSTALL_ID}")
        print(f"    {e.name or e.id}")
        print(f"    Vendor: {e.vendor}")
        print(f"    License: {_license_line(e.license)}")
        print(f"    Covers {e.species_count} species")
    return 0


def models_add(parser, args) -> int:
    def mutate(cfg: Config):
        from ..errors import ModelAlreadyExists

        if args.name in cfg.models:
            raise ModelAlreadyExists(args.name)
        cfg.models[args.name] = ModelConfig(
            path=args.path_, labels=args.labels,
            model_type=ModelType(args.type_))
        if args.set_default or cfg.defaults.model is None:
            cfg.defaults.model = args.name

    try:
        config_file.update_config(mutate)
    except BirdaError as e:
        print_error_chain(e)
        return 1
    print(f"Added model '{args.name}'")
    return 0


def models_check(parser, args) -> int:
    """Validate configured models: files exist, and (for ONNX models) the
    graph passes the whole-graph supportability preflight, every
    unsupported op/attribute/dtype reported at once."""
    from ..config.validate import validate_model_config

    structured = _structured(args.output_mode)
    cfg = config_file.load_default_config()
    failures = 0
    results = []
    for name, m in cfg.models.items():
        try:
            validate_model_config(name, m)
            issues = [] if args.no_graph else _graph_preflight(m)
            if issues:
                failures += 1
                results.append(env.model_check_entry(
                    id=name, valid=False,
                    error=f"{len(issues)} unsupported graph element(s)",
                    unsupported=issues))
                if not structured:
                    print(f"{name}: FAILED — {len(issues)} unsupported "
                          "graph element(s):")
                    for issue in issues:
                        print(f"    - {issue}")
                continue
            results.append(env.model_check_entry(id=name, valid=True))
            if not structured:
                print(f"{name}: OK")
        except BirdaError as e:
            failures += 1
            results.append(env.model_check_entry(id=name, valid=False,
                                                 error=str(e)))
            if not structured:
                print(f"{name}: FAILED — {e}")
    geomodel = _check_geomodel_info()
    leftovers = _find_leftover_downloads()
    if structured:
        reporter = create_reporter(args.output_mode)
        reporter.result(env.model_check_payload(
            models=results, geomodel=geomodel,
            leftover_downloads=leftovers or None))
        reporter.finish()
    else:
        if geomodel is not None:
            if geomodel["installed"]:
                print(f"BirdNET Geomodel v{geomodel['version']}: OK "
                      f"({geomodel['species_count']} species)")
            else:
                print(f"BirdNET Geomodel v{geomodel['version']}: not "
                      "installed (run 'birda models install geomodel' to "
                      "enable range filtering)")
            for p in geomodel.get("obsolete_files") or ():
                print(f"{p} is no longer used and can be deleted")
        for p in leftovers:
            print(f"leftover partial download: {p}")
    return 1 if failures else 0


def _check_geomodel_info() -> dict | None:
    """Shared range-filter status for ``models check``, reported once.
    None when the registry predates the geomodel."""
    from ..config.geomodel import default_geomodel_paths
    from ..registry.installer import find_obsolete_files, models_dir
    from ..registry.loader import load_registry

    try:
        reg = load_registry()
    except BirdaError:
        return None
    entry = reg.range_filter
    if entry is None:
        return None
    paths = default_geomodel_paths(reg)
    installed = (paths is not None and paths[0].exists()
                 and paths[1].exists())
    try:
        obsolete = [str(p) for p in find_obsolete_files(models_dir())]
    except OSError:
        obsolete = []
    return env.geomodel_info(
        version=entry.version, installed=installed,
        species_count=entry.species_count,
        model_path=str(paths[0]) if installed else None,
        labels_path=str(paths[1]) if installed else None,
        obsolete_files=obsolete or None)


def _find_leftover_downloads() -> list[str]:
    """Partial-download files (``<name>.<pid>.part``) whose writing process
    is gone. Reported, never deleted."""
    from ..registry.installer import models_dir

    out = []
    try:
        parts = sorted(models_dir().glob("*.part"))
    except OSError:
        return out
    for p in parts:
        bits = p.name.split(".")
        pid = None
        if len(bits) >= 3 and bits[-2].isdigit():
            pid = int(bits[-2])
        if pid is not None and _pid_alive(pid):
            continue  # a live download in progress, not a leftover
        out.append(str(p))
    return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _graph_preflight(m) -> list[str]:
    """The ONNX supportability preflight of a configured model's graph
    file: rendered findings, empty when fully supported. Non-ONNX paths
    (the ``synthetic:`` scheme) are skipped."""
    path = m.path
    if not str(path).endswith(".onnx") or not Path(path).is_file():
        return []
    from ..errors import OnnxExternalData
    from ..onnx.preflight import preflight

    try:
        return [f.render() for f in preflight(str(path))]
    except OnnxExternalData as e:
        return [str(e)]
    except Exception as e:  # noqa: BLE001 — unparseable graph is a finding
        return [f"graph failed to parse: {e}"]


def models_info(parser, args) -> int:
    """The geomodel install handle first, then the registry, then the
    configured models."""
    from ..registry.installer import GEOMODEL_INSTALL_ID
    from ..registry.loader import load_registry

    model_id, output_mode = args.model_id, args.output_mode
    structured = _structured(output_mode)

    def emit(details: dict):
        reporter = create_reporter(output_mode)
        reporter.result(env.model_info_payload(details))
        reporter.finish()

    if model_id == GEOMODEL_INSTALL_ID:
        from ..errors import RangeFilterAssetMissing

        try:
            entry = load_registry().range_filter
            if entry is None:
                raise RangeFilterAssetMissing("not present in this registry")
        except BirdaError as e:
            print_error_chain(e)
            return 1
        if structured:
            # "range-filter", not a classifier type: not a -m model.
            emit(env.model_details(id=GEOMODEL_INSTALL_ID,
                                   model_type="range-filter",
                                   source="registry"))
            return 0
        print(f"Range filter: {entry.name or entry.id}")
        if args.languages:
            print()
            print("The range filter has no label language variants. "
                  "Species names in output come from the active "
                  "classifier's own labels.")
            return 0
        from ..config.geomodel import human_size, total_download_size

        lic = entry.license
        print(f"ID: {GEOMODEL_INSTALL_ID}")
        print(f"Version: {entry.version}")
        print(f"Vendor: {entry.vendor}")
        print()
        print("Description:")
        print(f"  Scores {entry.species_count} species by location and "
              "time of year. Shared by every")
        print("  classifier; it is not selectable with -m.")
        print()
        print("License:")
        print(f"  Type: {lic.type}")
        print(f"  URL: {lic.url}")
        print(f"  Commercial use: {'Yes' if lic.commercial_use else 'No'}")
        print(f"  Attribution required: "
              f"{'Yes' if lic.attribution_required else 'No'}")
        print(f"  Share-alike required: "
              f"{'Yes' if lic.share_alike else 'No'}")
        print()
        print("Files:")
        print(f"  Model: {entry.model.url}")
        print(f"  Labels: {entry.labels.url}")
        print(f"  Download size: {human_size(total_download_size(entry))}")
        print()
        print(f"To install: birda models install {GEOMODEL_INSTALL_ID}")
        return 0

    from ..errors import ModelNotFoundInRegistry

    try:
        # Only a genuine not-in-registry falls through to the configured
        # models; a registry-layer failure surfaces its real cause.
        rm = load_registry().find_model(model_id)
    except ModelNotFoundInRegistry:
        rm = None
    except BirdaError as e:
        print_error_chain(e)
        return 1
    if rm is not None:
        if structured:
            emit(env.model_details(id=rm.id, model_type=rm.model_type,
                                   source="registry"))
            return 0
        if args.languages:
            from ..errors import ModelHasNoLanguages

            if rm.files is None:
                print_error_chain(ModelHasNoLanguages(rm.id))
                return 1
            print(f"Model: {rm.name}")
            print()
            print("Available label languages:")
            print()
            for lang in rm.files.languages:
                marker = (" (default)"
                          if lang.code == rm.files.default_language else "")
                print(f"  {lang.code} - {lang.name}{marker}")
            print()
            print("To install with specific language:")
            print(f"  birda models install {rm.id} --language <code>")
            return 0
        _print_registry_model(rm)
        return 0

    cfg = config_file.load_default_config()
    if model_id in cfg.models:
        m = cfg.models[model_id]
        if structured:
            emit(env.model_details(
                id=model_id, model_type=m.model_type.value,
                path=str(m.path), labels_path=str(m.labels),
                source="configured"))
            return 0
        print(f"{model_id} (configured)")
        print(f"  type: {m.model_type.value}")
        print(f"  path: {m.path}")
        print(f"  labels: {m.labels}")
        if m.installed_version:
            print(f"  installed version: {m.installed_version}")
        return 0
    from ..errors import ModelNotFound

    print_error_chain(ModelNotFound(model_id))
    return 1


def _print_registry_model(rm) -> None:
    """A registry model's full card: identity, license, files, variants."""
    from ..config.geomodel import human_size

    print(f"Model: {rm.name}")
    print(f"ID: {rm.id}")
    if rm.build is not None:
        # Upstream identity and the conversion revision of its weights.
        print(f"Version: {rm.version} (build {rm.build})")
    else:
        print(f"Version: {rm.version}")
    print(f"Vendor: {rm.vendor}")
    print()
    print("Description:")
    print(f"  {rm.description}")
    print()
    print("License:")
    print(f"  Type: {rm.license.type}")
    print(f"  URL: {rm.license.url}")
    print(f"  Commercial use: {'Yes' if rm.license.commercial_use else 'No'}")
    print(f"  Attribution required: "
          f"{'Yes' if rm.license.attribution_required else 'No'}")
    print(f"  Share-alike required: "
          f"{'Yes' if rm.license.share_alike else 'No'}")
    print()
    if rm.files is not None:
        print("Files:")
        print(f"  Model: {rm.files.model.url}")
        langs = rm.files.languages
        default_lang = next(
            (lg.name for lg in langs if lg.code == rm.files.default_language),
            "Unknown")
        if len(langs) == 1:
            print(f"  Labels: {default_lang} only")
        else:
            print(f"  Labels: {len(langs)} languages available "
                  f"(default: {default_lang})")
        print()
    if rm.has_variants:
        global_variants = [vv for vv in rm.variants if vv.region is None]
        regions = sorted({vv.region for vv in rm.variants if vv.region})
        print("Variants: " + ", ".join(vv.id for vv in global_variants))
        default_v = next((vv for vv in global_variants
                          if vv.id == rm.default_variant), None)
        if default_v is not None:
            count = (f"{default_v.classes} species" if default_v.classes
                     else "species count not published")
            print(f"  Global model: {count}, "
                  f"{human_size(default_v.model.size_bytes)}")
        print(f"  Regional models: {len(regions)} "
              f"(birda models regions {rm.id})")
        print()
    print(f"To install: birda models install {rm.id}")


def _confirm(prompt: str) -> bool:
    """A yes/no prompt on stdout read from stdin, default no; end of input
    (a closed stdin) is a no."""
    while True:
        sys.stdout.write(f"{prompt} [y/N]: ")
        sys.stdout.flush()
        line = sys.stdin.readline()
        if not line:
            return False
        answer = line.strip().lower()
        if answer in ("y", "yes"):
            return True
        if answer in ("", "n", "no"):
            return False
        print("Error: invalid input")


def models_remove(parser, args) -> int:
    name, purge = args.name, args.purge
    structured = _structured(args.output_mode)
    removed_entry = []
    promoted = []  # the new default model id when removal promoted one

    # Confirmed before the config lock is taken: the prompt waits on the
    # user, and the lock would block every other config write meanwhile.
    if purge and not structured and not args.yes:
        if not _confirm(f"This will delete model files for '{name}' from "
                        "disk. Continue?"):
            print("Removal cancelled.")
            return 0

    def mutate(cfg: Config):
        from ..errors import ModelNotFound

        if name not in cfg.models:
            raise ModelNotFound(name)
        removed_entry.append(cfg.models.pop(name))
        if cfg.defaults.model == name:
            # Alphabetical promotion: deterministic across config files
            # that list the same models in different orders.
            cfg.defaults.model = min(cfg.models, default=None)
            if cfg.defaults.model is not None:
                promoted.append(cfg.defaults.model)

    try:
        config_file.update_config(mutate)
    except BirdaError as e:
        if structured:
            reporter = create_reporter(args.output_mode)
            reporter.error("model_remove_failed", ErrorSeverity.FATAL, str(e))
            reporter.finish()
        print_error_chain(e)
        return 1

    first_error = None
    if purge:
        # Only the files this entry owned, skipping any another entry still
        # references; deleted after the config save, outside the lock.
        from ..registry.cleanup import owned_paths, referenced_model_paths

        still_referenced = referenced_model_paths(
            config_file.load_default_config())
        for file in owned_paths(removed_entry[0]):
            if file in still_referenced:
                if not structured:
                    print(f"  Skipped (used by another model): {file}")
                continue
            try:
                if file.exists():
                    file.unlink()
                    if not structured:
                        print(f"  Deleted: {file}")
                elif not structured:
                    print(f"  Skipped (not found): {file}")
            except OSError as e:
                if not structured:
                    print(f"  Failed to delete: {file}")
                if first_error is None:
                    first_error = (file, e)

    if structured:
        # Before any deletion error: the config change succeeded.
        reporter = create_reporter(args.output_mode)
        reporter.result(env.model_removed_payload(
            id=name, purge_requested=purge,
            new_default=promoted[0] if promoted else None))
        reporter.finish()
    else:
        print(f"Removed model '{name}'")
        if promoted:
            print(f"New default model: {promoted[0]}")
        else:
            cfg_after = config_file.load_default_config()
            if cfg_after.defaults.model is None and not cfg_after.models:
                print("Warning: no models remaining. Set a new default with "
                      "`birda models install`.")
    if first_error is not None:
        from ..errors import FileDeletionFailed

        e = FileDeletionFailed(str(first_error[0]), str(first_error[1]))
        e.__cause__ = first_error[1]
        print_error_chain(e)
        return 1
    return 0


def models_regions(parser, args) -> int:
    """Regional tiles grouped by continent, each with its species count and
    download size, listed once per region."""
    from ..config.geomodel import human_size
    from ..errors import RegionsNotSupported
    from ..registry.loader import load_registry

    model_id = args.model_id
    try:
        rm = load_registry().find_model(model_id)
        regional = [vv for vv in rm.variants if vv.region]
        if not regional:
            raise RegionsNotSupported(model_id)
    except BirdaError as e:
        print_error_chain(e)
        return 1
    # Each tile is the variant an install would pick (the default one),
    # not the first in manifest order.
    seen = {}
    for vv in regional:
        seen.setdefault(vv.region, vv)
        if rm.default_variant is not None and vv.id == rm.default_variant:
            seen[vv.region] = vv
    tiles = sorted(seen.values(), key=lambda vv: (
        vv.group_order, vv.group_name or "Other", vv.region))
    print(f"Regional variants of {rm.name}:")
    print()
    current_group = None
    for vv in tiles:
        group = vv.group_name or "Other"
        if group != current_group:
            if current_group is not None:
                print()
            print(f"{group}:")
            current_group = group
        count = (f"{vv.classes} species" if vv.classes
                 else "species count not published")
        print(f"  {vv.region:<24} {count:>28}   "
              f"{human_size(vv.model.size_bytes)}")
    print()
    print("A regional model scores only the species of that region, "
          "which cuts")
    print("memory use and latency. It is otherwise the same model.")
    print()
    print(f"To install: birda models install {model_id} --region <slug>")
    return 0


def _install_failed(args, e: BirdaError) -> int:
    if _structured(args.output_mode):
        reporter = create_reporter(args.output_mode)
        reporter.error("model_install_failed", ErrorSeverity.FATAL, str(e))
        reporter.finish()
    print_error_chain(e)
    return 1


def models_install(parser, args) -> int:
    from ..registry import installer
    from ..registry import license as license_mod
    from ..registry.loader import load_registry
    from ..registry.selection import select_variant

    model_id = args.model_id
    accept_license = args.accept_license or args.yes
    structured = _structured(args.output_mode)
    reg = load_registry()

    # The shared range filter installs under its own handle.
    if model_id == installer.GEOMODEL_INSTALL_ID:
        from ..errors import RangeFilterAssetMissing

        try:
            entry = reg.range_filter
            if entry is None:
                raise RangeFilterAssetMissing("not present in this registry")
            if not license_mod.prompt_license_acceptance(
                    entry.id, entry.name or entry.id, entry.license,
                    assume_yes=accept_license,
                    vendor=getattr(entry, "vendor", "") or ""):
                print("License not accepted; aborting.")
                return 1
            model_path, labels_path = installer.install_range_filter(entry)

            def set_geomodel(cfg: Config):
                cfg.defaults.geomodel = model_path
                cfg.defaults.geomodel_labels = labels_path

            config_file.update_config(set_geomodel)
        except BirdaError as e:
            return _install_failed(args, e)
        if structured:
            reporter = create_reporter(args.output_mode)
            reporter.result(env.model_installed_payload(
                id=installer.GEOMODEL_INSTALL_ID, set_as_default=False,
                model_path=str(model_path), labels_path=str(labels_path)))
            reporter.finish()
            return 0
        print(f"{entry.name or entry.id} installed.")
        print(f"  {model_path}")
        print(f"  {labels_path}")
        print(f"Range filtering covers {entry.species_count} species.")
        return 0

    try:
        rm = reg.find_model(model_id)
        # Variant/region resolution before the license gate: a typo'd
        # --region fails naming the known regions.
        chosen = None
        if rm.has_variants:
            chosen = select_variant(rm, explicit_variant=args.variant,
                                    region=args.region)
        else:
            # Ignoring these would install the global model while the user
            # asked for a regional or variant one.
            if args.region is not None:
                from ..errors import RegionsNotSupported

                raise RegionsNotSupported(model_id)
            if args.variant is not None:
                from ..errors import VariantNotFound

                raise VariantNotFound(
                    f"{args.variant} for {model_id} (none, this model "
                    "publishes a single file)")
        if not license_mod.prompt_license_acceptance(
                rm.id, rm.name, rm.license, assume_yes=accept_license,
                vendor=rm.vendor):
            print("License not accepted; aborting.")
            return 1

        # A download progress bar on stderr where it is a terminal.
        bar_state = {}

        def progress(done, total):
            if not sys.stderr.isatty():
                return
            from tqdm import tqdm

            bar = bar_state.get("bar")
            if bar is None or bar_state.get("total") != total:
                if bar is not None:
                    bar.close()
                bar = tqdm(total=total, unit="B", unit_scale=True,
                           file=sys.stderr, leave=False)
                bar_state.update(bar=bar, total=total, done=0)
            bar.update(done - bar_state["done"])
            bar_state["done"] = done

        try:
            installed = installer.install_model(
                rm, language=args.language, variant=chosen,
                progress=progress)
        finally:
            if bar_state.get("bar") is not None:
                bar_state["bar"].close()
        # The geomodel installs alongside range-filter-capable models.
        from ..config.range_filter import supports_range_filter

        if reg.range_filter is not None and supports_range_filter(
                bat_mode=False, model_type=ModelType(rm.model_type)):
            try:
                installer.install_range_filter(reg.range_filter)
            except BirdaError as e:
                # A warning: the classifier installed and works without
                # range filtering.
                logging.getLogger("birda").warning(
                    "Could not install the BirdNET Geomodel v3.0.2 range "
                    "filter: %s. Run 'birda models install geomodel' to "
                    "retry.", e)

        became_default = []
        # Regional installs get an `<id>-<region>` config key, the name a
        # user types with -m.
        config_key = (f"{model_id}-{installed.region}"
                      if installed.region else model_id)
        orphans = []

        def mutate(cfg: Config):
            from ..registry.cleanup import orphaned_files

            # Collected before the insert overwrites the entry that names
            # them, deleted only after the config is saved.
            keeping = [installed.model_path, installed.labels_path]
            keeping.extend(p for p in installed.extra.values() if p)
            orphans[:] = orphaned_files(cfg, config_key, keeping)
            cfg.models[config_key] = ModelConfig(
                path=installed.model_path,
                labels=installed.labels_path,
                model_type=ModelType(rm.model_type),
                registry_id=rm.id,
                installed_version=rm.version,
                variant=installed.variant,
                region=installed.region,
                bsg_calibration=installed.extra.get("bsg_calibration"),
                bsg_migration=installed.extra.get("bsg_migration"),
                bsg_distribution_maps=installed.extra.get(
                    "bsg_distribution_maps"))
            if args.set_default or cfg.defaults.model is None:
                cfg.defaults.model = config_key
                became_default.append(config_key)

        config_file.update_config(mutate)
        from ..registry.cleanup import remove_orphans

        for path, err in remove_orphans(orphans):
            logger.warning("Could not remove the superseded model file %s: "
                           "%s", path, err)
    except BirdaError as e:
        return _install_failed(args, e)
    if structured:
        reporter = create_reporter(args.output_mode)
        reporter.result(env.model_installed_payload(
            id=config_key, set_as_default=bool(became_default),
            model_path=str(installed.model_path),
            labels_path=str(installed.labels_path)))
        reporter.finish()
        return 0
    print(f"Installed {config_key}")
    return 0


# ---------------------------------------------------------------------------
# version / providers / clip / update
# ---------------------------------------------------------------------------

def version(parser, args) -> int:
    """The birda version (VersionPayload in the structured modes)."""
    if _structured(args.output_mode):
        reporter = create_reporter(args.output_mode)
        reporter.result(env.version_payload(__version__))
        reporter.finish()
        return 0
    print(f"birda {__version__}")
    return 0


def providers(parser, args) -> int:
    """The inference backends this process can run on: the CUDA card (by
    name) and the CPU. A CUDA query answers at once, so no bounded probe
    is needed."""
    from ..inference.backend import available_backends, provider_metadata

    avail = available_backends()
    if _structured(args.output_mode):
        reporter = create_reporter(args.output_mode)
        reporter.result(env.providers_payload([
            env.provider_info(**provider_metadata(p)) for p in avail]))
        reporter.finish()
        return 0
    print("Available execution providers:")
    print()
    for name in ("cuda", "cpu"):
        mark = (provider_metadata(name)["description"] if name in avail
                else "not available")
        print(f"  {name}: {mark}")
    print()
    print("Usage:")
    print("  (default)      The CUDA card (fails without one)")
    print("  --cpu          Force CPU only")
    print()
    print("Explicit providers (fail if unavailable):")
    print("  --gpu, --cuda  Require the CUDA card")
    return 0


def clip(parser, args) -> int:
    """Extract audio clips from detection results."""
    from ..clipper.command import ClipArgs, execute
    from ..errors import ClipBatchAllFailed

    files, audio = list(args.files), args.audio
    if (args.start is None) != (args.end is None):
        parser.error("--start and --end must be given together")
    if args.start is not None:
        # Direct mode: --audio or positional audio files, not both.
        if audio is not None and files:
            parser.error("direct mode takes either --audio or positional "
                         "FILES, not both")
        if audio is not None:
            files = [audio]
        if not files:
            parser.error("--start/--end requires --audio")
    elif not files:
        parser.error("Missing argument 'FILES...'.")

    clip_args = ClipArgs(
        files=files, output=args.output, audio=audio, base_dir=args.base_dir,
        pre=args.pre, post=args.post, confidence=args.confidence or 0.0,
        species=args.species_, start=args.start, end=args.end)
    output_mode = args.output_mode
    structured = _structured(output_mode)
    reporter = create_reporter(output_mode) if structured else None
    all_failed = False
    try:
        # Per-file error events stream in NDJSON mode only: plain json is
        # one document.
        summary = execute(clip_args, reporter=(
            reporter if output_mode == "ndjson" else None))
    except ClipBatchAllFailed as e:
        # Total failure still emits the one result document listing every
        # failure, then exits non-zero.
        summary = e.summary
        all_failed = True
        if not structured:
            print_error_chain(e)
    except BirdaError as e:
        if structured:
            reporter.error("clip_extraction_failed", ErrorSeverity.FATAL,
                           str(e))
            reporter.finish()
        print_error_chain(e)
        return 1
    if structured:
        reporter.result(env.clip_extraction_payload(
            output_dir=str(clip_args.output),
            total_clips=summary.total_clips,
            total_files=summary.processed_files,
            clips=[env.clip_extraction_entry(
                source_audio=c["source_audio"], scientific_name=c["species"],
                confidence=c["confidence"], start_time=c["start"],
                end_time=c["end"], output_file=c["path"])
                for c in summary.clips],
            failed_files=[env.clip_extraction_failure(file=f["file"],
                                                      error=f["message"])
                          for f in summary.failures]))
        reporter.finish()
        return 1 if all_failed else 0
    print(f"Extracted {summary.total_clips} clip(s) from "
          f"{summary.processed_files} file(s)")
    if summary.failures:
        logger.warning("%d detection file(s) failed to process",
                       len(summary.failures))
    return 1 if all_failed else 0


def update(parser, args) -> int:
    """Check for and install updates."""
    from ..update import check_for_update, perform_update

    try:
        info = check_for_update()
        if info is None:
            print("birda is up to date")
            return 0
        print(f"Update available: {info.version}")
        if not args.check:
            perform_update(info)
            print("Updated. Restart birda to use the new version.")
    except BirdaError as e:
        print_error_chain(e)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # A global `--output-mode` before the subcommand reaches every
    # subcommand through BIRDA_OUTPUT_MODE (a command's own flag still
    # wins), and is never read as an analyze input.
    while argv and (argv[0] == "--output-mode"
                    or argv[0].startswith("--output-mode=")):
        if argv[0] == "--output-mode":
            if len(argv) < 2:
                break  # the parser reports the missing value
            os.environ["BIRDA_OUTPUT_MODE"] = argv[1]
            argv = argv[2:]
        else:
            os.environ["BIRDA_OUTPUT_MODE"] = argv[0].split("=", 1)[1]
            argv = argv[1:]
    if not argv:
        # First-run smart help: the setup guide when no models are
        # configured, a usage reminder otherwise.
        from .help import smart_help

        try:
            cfg = config_file.load_default_config()
        except BirdaError:
            cfg = Config()
        print(smart_help(cfg))
        return 0
    if argv[0] == "--version":
        print(f"birda, version {__version__}")
        return 0
    # `birda file.wav` is `birda analyze file.wav`.
    if argv[0] not in SUBCOMMANDS and argv[0] not in ("--help", "-h"):
        argv = ["analyze", *argv]
    parser = build_parser()
    try:
        args = parser.parse_args(argv)
        if args.command == "analyze":
            _finish_analyze_args(parser, args)
            return analyze(args)
        if args.command == "species":
            return species(parser, args)
        return args.handler(parser, args)
    except BirdaError as e:
        # The last-resort cause-chain printer: a typed error no command
        # renders itself (a corrupt config under `config show`, a corrupt
        # registry cache under `models install`) never reaches the user as
        # a traceback.
        print_error_chain(e)
        return 1


if __name__ == "__main__":
    sys.exit(main())
