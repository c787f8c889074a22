"""``analyze --cpu --precision P`` in both packages on the same recording:
the detection tables that ``tests/test_torch_quantize.py::
test_analyze_cpu_precision_matches_jax`` compares, and, as a script, their
differences on the tiny v2.4 and v3.0 graphs (seed 1):

    JAX_PLATFORMS=cpu python3 tests/torch_cpu_precision_parity.py [ROOT]

``ROOT`` (default: this checkout) is the checkout whose ``birda_tpu_torch``
runs beside this checkout's JAX package, so an older tree's port can be
read against the same reference. Each run gets its own ``XDG_*`` home
under ``$TMPDIR``; int8 and mixed calibrate in the JAX run and the port's
run reads the cached scales. Prints one JSON line per graph and precision:
rows of each table, rows kept by one package only, and the largest
confidence difference over the rows both keep.
"""

from __future__ import annotations

import csv
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

MIN_CONFIDENCE = 0.05
MODEL_TYPES = {"v24": "birdnet-v24", "v30": "birdnet-v30",
               "perch": "perch-v2"}


def write_inputs(home: Path, key: str, graph):
    """The graph and its labels as files, and a 6 s 2.5 kHz tone at its
    sample rate (the JAX package's TestEndToEndParity input)."""
    from fixtures_audio import write_wav

    from birda_tpu_torch.models.zoo import synthetic_labels

    model_file = home / f"tiny-{key}.onnx"
    model_file.write_bytes(graph.model_bytes)
    labels_file = home / f"labels-{key}.txt"
    labels_file.write_text("".join(
        f"{s}\n" for s in synthetic_labels(graph.spec.num_classes)))
    rate = graph.spec.sample_rate
    t = np.arange(rate * 6) / rate
    audio = home / f"rec-{key}.wav"
    write_wav(audio, (0.4 * np.sin(2 * np.pi * 2500 * t)).astype(np.float32),
              rate)
    return model_file, labels_file, MODEL_TYPES[key], audio


def _rows(outdir: Path):
    (table,) = outdir.glob("*.csv")
    with open(table, encoding="utf-8-sig") as f:
        return table.name, list(csv.DictReader(f))


def analyze_both(home: Path, key: str, graph, precision: str):
    """``((name, rows) of the JAX run, (name, rows) of the port's run)``:
    both packages' ``analyze_files`` on the CPU, the JAX run first."""
    from birda_tpu.config.types import Config as JaxConfig
    from birda_tpu.config.types import ModelType as JaxModelType
    from birda_tpu.orchestrator import AnalyzeOptions as JaxOptions
    from birda_tpu.orchestrator import analyze_files as jax_analyze

    from birda_tpu_torch.config.types import Config, ModelType
    from birda_tpu_torch.orchestrator import AnalyzeOptions, analyze_files

    model_file, labels_file, model_type, audio = write_inputs(home, key,
                                                              graph)
    kw = dict(inputs=[audio], device_flags={"cpu": True},
              precision=precision, min_confidence=MIN_CONFIDENCE,
              model_path=model_file, labels_path=labels_file)
    assert jax_analyze(JaxOptions(output_dir=home / "jax",
                                  model_type=JaxModelType(model_type), **kw),
                       JaxConfig()) == 0
    assert analyze_files(AnalyzeOptions(output_dir=home / "port",
                                        model_type=ModelType(model_type),
                                        **kw), Config()) == 0
    return _rows(home / "jax"), _rows(home / "port")


def windows(rows) -> dict:
    """``{(start, end): {species: confidence}}`` of a detection table."""
    out = {}
    for r in rows:
        out.setdefault((r["Start (s)"], r["End (s)"]), {})[
            r["Scientific name"]] = float(r["Confidence"])
    return out


def differences(want, got) -> dict:
    a = {(w, s): c for w, sp in windows(want).items() for s, c in sp.items()}
    b = {(w, s): c for w, sp in windows(got).items() for s, c in sp.items()}
    both = a.keys() & b.keys()
    return {"rows_jax": len(a), "rows_port": len(b),
            "rows_in_one_only": len(a.keys() ^ b.keys()),
            "max_abs_common": max((abs(a[k] - b[k]) for k in both),
                                  default=None)}


def main(argv) -> int:
    root = Path(argv[0]).resolve() if argv else \
        Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(Path(__file__).resolve().parent)]
    from birda_tpu_torch.onnx import fullscale as fs

    specs = {"v24": fs.BIRDNET_V24_SPEC, "v30": fs.BIRDNET_V30_SPEC}
    for key, spec in specs.items():
        graph = fs.build(fs.tiny_spec(spec), seed=1)
        for precision in ("bf16", "int8", "mixed"):
            home = Path(tempfile.mkdtemp(prefix="birda-cpu-precision-"))
            for k in ("CONFIG", "CACHE", "DATA"):
                os.environ[f"XDG_{k}_HOME"] = str(home / k.lower())
            (_, want), (_, got) = analyze_both(home, key, graph, precision)
            print(json.dumps({"graph": key, "precision": precision,
                              **differences(want, got)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
