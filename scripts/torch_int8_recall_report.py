#!/usr/bin/env python3
"""Render the int8 recall-validation report for a real model and inputs
with the PyTorch port: the counterpart of ``scripts/int8_recall_report.py``.

The day-one acceptance tool for ``--precision int8`` on a new asset
(protocol and criteria: ``birda_tpu_torch/onnx/int8_accuracy.py``). Inputs
come from either route:

- ``--reference ref.npz``: the score-parity recording
  (``scripts/record_parity_reference.py``); its ``inputs`` waveforms are
  scored through the fp32 and int8 lowerings;
- ``--audio FILE|DIR [--sample-rate R --seconds S]``: real recordings
  decoded, cut into segments and resampled on the host through the port's
  audio stack (``audio/decode.py``, ``ops/resample.py::resample_numpy``).

Both lowerings and the calibration run on ``cuda:0`` (the tool raises
without a card) unless ``--cpu`` asks for the CPU.

Usage:
    python3 scripts/torch_int8_recall_report.py MODEL.onnx --reference r.npz
    python3 scripts/torch_int8_recall_report.py MODEL.onnx --audio recs/ \\
        --sample-rate 48000 --seconds 3 [--calibration-audio calib/] [--cpu]

Prints the device, the report and the acceptance verdict. Exit 0 when
every acceptance criterion passes, 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _collect_audio(spec: str) -> list[Path]:
    """Resolve --audio/--calibration-audio to decodable files: a directory
    keeps only supported audio extensions; an explicit file path is passed
    through as given."""
    from birda_tpu_torch.constants import audio as audio_consts

    root = Path(spec)
    if not root.is_dir():
        return [root]
    exts = {"." + e for e in audio_consts.SUPPORTED_EXTENSIONS}
    files = [p for p in sorted(root.rglob("*")) if p.is_file()]
    paths = [p for p in files if p.suffix.lower() in exts]
    skipped = len(files) - len(paths)
    if skipped:
        print(f"note: skipped {skipped} non-audio file(s) under {root}",
              file=sys.stderr)
    if not paths:
        raise SystemExit(f"no supported audio files under {root} "
                         f"(extensions: {sorted(exts)})")
    return paths


def _segments_from_audio(paths, sample_rate: int, seconds: float,
                         limit: int) -> np.ndarray:
    """Decode, window and resample on the host through the port's audio
    stack."""
    from birda_tpu_torch.audio.decode import StreamingDecoder
    from birda_tpu_torch.ops.resample import resample_numpy

    seg_model = int(round(sample_rate * seconds))
    out = []
    for p in paths:
        dec = StreamingDecoder(p)
        try:
            src_seg = int(round(dec.sample_rate * seconds))
            while len(out) < limit:
                raw = dec.next_segment(src_seg, 0)
                if raw is None:
                    break
                window = raw.samples
                if dec.sample_rate != sample_rate:
                    window = resample_numpy(window, dec.sample_rate,
                                            sample_rate)
                if len(window) < seg_model:
                    window = np.pad(window, (0, seg_model - len(window)))
                out.append(np.asarray(window[:seg_model], np.float32))
        finally:
            dec.close()
        if len(out) >= limit:
            break
    if not out:
        raise SystemExit("no segments decoded from the given audio")
    return np.stack(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", help="classifier ONNX file")
    ap.add_argument("--reference", help="parity-recording .npz (inputs key)")
    ap.add_argument("--audio", help="recording file or directory")
    ap.add_argument("--sample-rate", type=int, default=48_000)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--calibration-audio",
                    help="separate recordings for the calibration pass "
                         "(defaults to the evaluation segments themselves)")
    ap.add_argument("--limit", type=int, default=512,
                    help="max evaluation segments")
    ap.add_argument("--labels", help="labels file for species names")
    ap.add_argument("--cpu", action="store_true",
                    help="run both lowerings and the calibration on the CPU")
    args = ap.parse_args(argv)

    if bool(args.reference) == bool(args.audio):
        ap.error("exactly one of --reference / --audio is required")

    import torch

    from birda_tpu_torch.inference.backend import select_backend
    from birda_tpu_torch.onnx.int8_accuracy import Criteria, evaluate_model

    dev = select_backend("cpu" if args.cpu else "auto")[0][0]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"device: {dev} ({name})")

    if args.reference:
        inputs = np.load(args.reference)["inputs"]
    else:
        inputs = _segments_from_audio(_collect_audio(args.audio),
                                      args.sample_rate,
                                      args.seconds, args.limit)
    inputs = inputs[:args.limit]

    calib = None
    if args.calibration_audio:
        seg = _segments_from_audio(_collect_audio(args.calibration_audio),
                                   args.sample_rate, args.seconds, 64)
        calib = [torch.from_numpy(seg).to(dev)]

    x = torch.from_numpy(np.ascontiguousarray(inputs, np.float32)).to(dev)
    report = evaluate_model(args.model, x, calibration_batches=calib)
    labels = None
    if args.labels:
        labels = Path(args.labels).read_text().splitlines()
    print(report.render(labels))
    fails = report.failures(Criteria())
    if fails:
        print("\nACCEPTANCE FAILURES:")
        for f in fails:
            print(f"  - {f}")
        return 1
    print("\nall acceptance criteria pass")
    return 0


if __name__ == "__main__":
    sys.exit(main())
