#!/usr/bin/env python3
"""Run the port's hand-written front-end kernels at the release-graph
front-end geometries on the card, at the wide ones that take fewer frames
per block or several mel passes, and the front-end routes through the
evaluator: the CUDA counterpart of ``scripts/verify_kernels_tpu.py``.

    python3 scripts/verify_kernels_cuda.py

Run it from the root of a checkout, on a machine with a CUDA card (give the
command a time limit of its own: the kernels' ring barriers spin without a
timeout). It builds ``birda_tpu_torch/csrc`` at first use.

1. ``conv1d_stft`` and ``fused_logmel`` (``birda_tpu_torch/ops/
   stft_conv.py``) at verify_kernels_tpu.py's three geometries, (S, K, hop,
   mels) = (144,000, 2048, 278, 128), (160,000, 1024, 320, 96) and
   (160,000, 640, 320, 160), batch 4, with its inputs and its bounds: the
   conv's max error over max |want| below 2e-2 and the log-mel's q99
   absolute error below 5e-2, against float64 products of the
   bf16-rounded operands. Each is also held against its plain PyTorch
   version and timed beside it (CUDA events), with the least time the card
   could take (``bound_ms``).
2. The same at :data:`WIDE_CASES`: hops whose span of 128 frames a block
   cannot hold (64 frames per block at hop 512/K 2048, hop 1024/K 1024 and
   hop 640/K 1280; rows of the window alone at hops past it, as the tiny
   test graphs stride; 16 and 8 frames at 4096- and 8192-sample windows)
   and 320 mels (two passes of 160).
3. Each geometry of ``tests/torch_route_graphs.py`` through the port's
   evaluator in bf16 (``lower``): it prints the route the node takes
   (``kernel`` or ``composed``, from ``stft_conv.ROUTES``) and the
   kernels it launched, and holds the output against the port's CPU run of
   the same graph within 2e-2 of the largest magnitude. No case may raise.

Prints the card's name and power limit, one JSON line per case and a
final summary; exit 1 on any failure or without a CUDA device.
``chip_smoke.py`` runs the same cases (``verify_kernels``,
``kernel_routes``) through :func:`stft_case` and :func:`route_case`.
"""

from __future__ import annotations

import json
import sys
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from birda_tpu_torch.inference.backend import card_line  # noqa: E402
from birda_tpu_torch.ops.measure import bound, timed_ms  # noqa: E402

#: (name, S, K, hop, n_mels): verify_kernels_tpu.py's release front-end
#: geometries (v2.4 48 kHz/3 s, v3.0 32 kHz/5 s, Perch v2 32 kHz/5 s), at
#: its batch.
STFT_CASES = [
    ("v24", 144_000, 2048, 278, 128),
    ("v30", 160_000, 1024, 320, 96),
    ("perch", 160_000, 640, 320, 160),
]
#: (name, S, K, hop, n_mels) where the kernels take fewer than 128 frames
#: per block or more than one mel pass.
WIDE_CASES = [
    ("hop512_k2048", 144_000, 2048, 512, 128),
    ("hop1024_k1024", 160_000, 1024, 1024, 128),
    ("hop640_k1280", 160_000, 1280, 640, 128),
    ("mels320", 160_000, 1024, 320, 320),
    ("hop2224_k2048", 144_000, 2048, 2224, 48),
    ("hop2560_k640", 160_000, 640, 2560, 40),
    ("hop4096_k4096", 160_000, 4096, 4096, 128),
    ("hop8192_k8192", 160_000, 8192, 8192, 128),
]
BATCH = 4
CONV_REL_BOUND = 2e-2
LOGMEL_Q99_BOUND = 5e-2
ROUTE_REL_BOUND = 2e-2
EPS = 1e-6


def stft_case(name: str, s: int, k: int, hop: int, mels: int, batch: int,
              dev) -> dict:
    """Both kernels at one geometry against float64 and their plain
    versions, timed on a card."""
    import torch

    from birda_tpu_torch.ops import stft_conv

    bins = k // 2 + 1
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 0.3, (batch, s)).astype(np.float32))
    w = torch.from_numpy(
        rng.normal(0, 0.05, (2 * bins, k)).astype(np.float32))
    fb = torch.from_numpy(
        rng.uniform(0, 0.05, (bins, mels)).astype(np.float32))
    x, w, fb = x.to(dev), w.to(dev), fb.to(dev)
    fits = (stft_conv.conv1d_kernel_fits(s, k, hop, 2 * bins),
            stft_conv.logmel_kernel_fits(s, k, hop, 2 * bins, mels))
    conv_layout = logmel_layout = None
    if dev.type == "cuda":
        conv_layout = stft_conv.prepare_conv1d_weights(w)
        logmel_layout = stft_conv.prepare_logmel_weights(w, fb)

    def conv():
        return stft_conv.conv1d_stft(x, w, hop, prepared=conv_layout)

    def logmel():
        return stft_conv.fused_logmel(x, w, fb, hop, EPS,
                                      prepared=logmel_layout)

    before = dict(stft_conv.LAUNCHES)
    got = conv().double()
    got2 = logmel().double()
    launches = {n: stft_conv.LAUNCHES[n] - before.get(n, 0)
                for n in ("conv1d_stft", "fused_logmel")}
    # float64 products of the bf16-rounded operands.
    xr = x.to(torch.bfloat16).double()
    wr = w.to(torch.bfloat16).double()
    want = torch.matmul(xr.unfold(-1, k, hop), wr.T).transpose(1, 2)
    e1 = float((got - want).abs().max() / want.abs().max())
    power = want[:, :bins] ** 2 + want[:, bins:] ** 2
    ref_log = torch.log(torch.einsum("bct,cm->btm", power, fb.double())
                        + EPS)
    e2 = float(torch.quantile((got2 - ref_log).abs().flatten().float(),
                              0.99))
    plain_conv = stft_conv.conv1d_stft_reference(x, w, hop).double()
    plain_log = stft_conv.fused_logmel_reference(x, w, fb, hop,
                                                 EPS).double()
    t = (s - k) // hop + 1
    rec = {"case": name, "geometry": {"batch": batch, "s": s, "k": k,
                                      "hop": hop, "c": 2 * bins,
                                      "mels": mels},
           "fits": {"conv1d_stft": fits[0], "fused_logmel": fits[1]},
           "frames_per_block": {
               "conv1d_stft": stft_conv.conv1d_frames(hop, k),
               "fused_logmel": stft_conv.logmel_frames(hop, k)},
           "mel_passes": stft_conv.mel_passes(mels)[0],
           "launches": launches,
           "conv_rel_err": e1, "logmel_q99_err": e2,
           "conv_max_abs_err_vs_plain": float(
               (got - plain_conv).abs().max()),
           "logmel_max_abs_err_vs_plain": float(
               (got2 - plain_log).abs().max()),
           "ok": bool(all(fits) and e1 < CONV_REL_BOUND
                      and e2 < LOGMEL_Q99_BOUND)}
    if dev.type == "cuda":
        rec["ok"] = rec["ok"] and launches == {"conv1d_stft": 1,
                                               "fused_logmel": 1}
        conv_bytes = x.numel() * 4 + w.numel() * 2 + batch * 2 * bins * t * 2
        log_bytes = x.numel() * 4 + w.numel() * 2 + fb.numel() * 2 \
            + batch * t * mels * 2
        rec["conv1d_stft"] = {
            "ms": timed_ms(conv),
            "plain_ms": timed_ms(
                lambda: stft_conv.conv1d_stft_reference(x, w, hop)),
            **bound(conv_bytes, 2 * batch * t * k * 2 * bins)}
        rec["fused_logmel"] = {
            "ms": timed_ms(logmel),
            "plain_ms": timed_ms(
                lambda: stft_conv.fused_logmel_reference(x, w, fb, hop,
                                                         EPS)),
            **bound(log_bytes, 2 * batch * t * (k * 2 * bins + bins * mels))}
    return rec


def route_case(case, batch: int, dev, s: int | None = None) -> dict:
    """One geometry of ``tests/torch_route_graphs.py`` (at ``s`` samples,
    its own by default) through ``lower`` in bf16 on ``dev``: the route its
    node took, the kernels it launched and its output against the port's
    CPU run."""
    import torch

    import torch_route_graphs as rg

    from birda_tpu_torch.models import zoo
    from birda_tpu_torch.onnx.lowering import lower
    from birda_tpu_torch.ops import stft_conv

    mb = rg.build(case, s)
    x = torch.from_numpy(rg.inputs(case, batch, s))

    def run(device):
        fn = lower(mb, compute_dtype=torch.bfloat16)
        params = zoo.params_from_numpy(fn.params, device, torch.bfloat16)
        fn.prepare(params)
        routes, launches = dict(stft_conv.ROUTES), dict(stft_conv.LAUNCHES)
        out = fn(x.to(device), params=params)
        if device.type == "cuda":
            torch.cuda.synchronize()
        took = {k: v - routes.get(k, 0) for k, v in stft_conv.ROUTES.items()
                if v != routes.get(k, 0)}
        fired = {k: v - launches.get(k, 0)
                 for k, v in stft_conv.LAUNCHES.items()
                 if v != launches.get(k, 0)}
        return out.float().cpu(), took, fired

    got, took, fired = run(dev)
    reference = run(torch.device("cpu"))[0]
    err = float((got - reference).abs().max() / reference.abs().max())
    route = next(iter(took), "").split(":")[-1]
    want_fired = {case.kernel: 1} if (route == "kernel"
                                      and dev.type == "cuda") else {}
    return {"case": case.name, "kernel": case.kernel, "route": route,
            "expected_route": case.route, "routes": took, "launches": fired,
            "shape": list(got.shape), "rel_err_vs_cpu": err,
            "finite": bool(torch.isfinite(got).all()),
            "ok": bool(took == {f"{case.kernel}:{case.route}": 1}
                       and fired == want_fired
                       and err <= ROUTE_REL_BOUND
                       and torch.isfinite(got).all())}


def main() -> int:
    import torch

    import torch_route_graphs as rg

    if not torch.cuda.is_available():
        print("verify_kernels_cuda: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    failures = 0
    for name, s, k, hop, mels in STFT_CASES + WIDE_CASES:
        try:
            rec = stft_case(name, s, k, hop, mels, BATCH, dev)
        except Exception as e:  # noqa: BLE001 — report every case
            rec = {"case": name, "error": f"{type(e).__name__}: {e}"[:2000],
                   "ok": False}
            traceback.print_exc(limit=3)
        failures += not rec["ok"]
        print(json.dumps({"kernel": "stft/logmel", **rec}), flush=True)
    for case in rg.CASES:
        try:
            rec = route_case(case, 2, dev)
        except Exception as e:  # noqa: BLE001
            rec = {"case": case.name, "error":
                   f"{type(e).__name__}: {e}"[:2000], "ok": False}
            traceback.print_exc(limit=3)
        failures += not rec["ok"]
        print(json.dumps({"kernel": "route", **rec}), flush=True)
    print(json.dumps({"failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
