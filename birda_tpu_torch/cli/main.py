"""Command line of the PyTorch/CUDA port: ``analyze`` on the card.

    python -m birda_tpu_torch.cli.main analyze rec.wav -m birdnet-v24 \\
        --gpu --precision bf16 -o out/

The analyze flags this port runs, with the meaning and validation of the
JAX package's ``birda analyze`` (``birda_tpu/cli/main.py``); its other
subcommands (config, models, species, clip, ...) need no accelerator and
stay with ``birda``. Built on :mod:`argparse`, so the port needs no click.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from . import validators as v
from ..config import file as config_file
from ..config.types import ModelType, OutputMode
from ..errors import BirdaError
from ..output.json_envelope import ErrorSeverity
from ..output.reporter import create_reporter
from ..pipeline.coordinator import OutputFormat

logger = logging.getLogger(__name__)


def _checked(parse):
    """An argparse type from a :mod:`birda_tpu_torch.cli.validators`
    parser."""

    def convert(s):
        try:
            return parse(s)
        except v.ValidationFailure as e:
            raise argparse.ArgumentTypeError(str(e)) from e

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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m birda_tpu_torch.cli.main",
        description="birda on PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
    a = sub.add_parser("analyze",
                       help="Analyze audio files for bird detections.")
    a.add_argument("inputs", nargs="+", type=Path)
    a.add_argument("-m", "--model", help="Configured model name.")
    a.add_argument("--model-path", type=Path, help="Ad-hoc model graph path.")
    a.add_argument("--labels-path", type=Path)
    a.add_argument("--model-type", choices=[t.value for t in ModelType])
    a.add_argument("-f", "--format", dest="formats", action="append",
                   type=_formats, default=[],
                   help="Output formats, comma-separated: "
                        + ", ".join(f.value for f in OutputFormat)
                        + " ('table' = raven).")
    a.add_argument("-o", "--output-dir", type=Path)
    a.add_argument("-c", "--min-confidence",
                   type=_checked(v.parse_confidence),
                   help=f"Minimum confidence {v.HELP_RANGES['confidence']}.")
    a.add_argument("--overlap", type=_checked(v.parse_overlap))
    a.add_argument("-b", "--batch-size", type=_checked(v.parse_batch_size),
                   help=f"Inference batch size "
                        f"{v.HELP_RANGES['batch_size']}.")
    a.add_argument("--combine", action="store_true")
    a.add_argument("--force", action="store_true")
    a.add_argument("--fail-fast", action="store_true")
    a.add_argument("-q", "--quiet", action="store_true")
    a.add_argument("-v", "--verbose", action="count", default=0)
    a.add_argument("--no-csv-bom", action="store_true")
    dev = a.add_mutually_exclusive_group()
    dev.add_argument("--gpu", "--cuda", dest="gpu", action="store_true",
                     help="Require a CUDA device (fail if unavailable).")
    dev.add_argument("--cpu", action="store_true", help="Force CPU.")
    a.add_argument("--slist", type=Path)
    a.add_argument("--stale-lock-timeout",
                   type=_checked(v.parse_stale_lock_timeout))
    a.add_argument("--stdout", dest="stdout_mode", action="store_true",
                   help="Stream detections to stdout; write no files.")
    a.add_argument("--output-mode", choices=["human", "json", "ndjson"])
    a.add_argument("--decode-workers", type=int, default=0,
                   help="Decode threads per file: 0 = auto, 1 = one.")
    a.add_argument("--precision", choices=["fp32", "bf16", "mixed", "int8"],
                   default="fp32",
                   help="ONNX graph precision: fp32 = full fp32 (TF32 off); "
                        "bf16 = bf16 matmuls/convs with fp32 accumulation "
                        "and the fused front-end kernel; mixed = bf16 "
                        "compute with calibrated int8 storage of the large "
                        "boundary streams; int8 = calibrated int8 "
                        "quantization of the heavy matmuls/convs with int32 "
                        "accumulation (the TensorRT-int8 analogue).")
    a.add_argument("--calibration-audio", type=Path,
                   help="Representative audio (file or directory) to "
                        "calibrate int8 activation scales on (--precision "
                        "int8/mixed); default is a built-in synthetic set "
                        "whose scales are cached per graph.")
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


def analyze(args: argparse.Namespace) -> int:
    from ..config.validate import validate_config

    from ..orchestrator import AnalyzeOptions, analyze_files

    init_logging(args.verbose, args.quiet)
    formats = [f for group in args.formats for f in group]
    if args.stdout_mode and (args.combine or args.output_dir is not None
                             or formats):
        sys.stderr.write(
            "Error: --stdout conflicts with --combine/--output-dir/--format\n")
        return 2
    try:
        config = config_file.load_default_config()
        validate_config(config)
    except BirdaError as e:
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

        reporter = HumanReporter(enabled=not args.quiet)

    options = AnalyzeOptions(
        inputs=list(args.inputs),
        model=args.model,
        model_path=args.model_path,
        labels_path=args.labels_path,
        model_type=ModelType(args.model_type) if args.model_type else None,
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
        slist=args.slist,
        stale_lock_timeout=args.stale_lock_timeout,
        stdout_mode=args.stdout_mode,
        dual_output_mode=dual,
        decode_workers=args.decode_workers,
        precision=args.precision,
        calibration_audio=args.calibration_audio,
    )
    try:
        code = analyze_files(options, config, reporter)
    except BirdaError as e:
        reporter.error("analysis_failed", ErrorSeverity.FATAL, str(e))
        reporter.finish()
        print_error_chain(e)
        return 1
    reporter.finish()
    return code


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.calibration_audio is not None and \
            args.precision not in ("int8", "mixed"):
        parser.error("--calibration-audio only applies with --precision "
                     "int8/mixed")
    return analyze(args)  # the only subcommand


if __name__ == "__main__":
    sys.exit(main())
