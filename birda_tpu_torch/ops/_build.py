"""Build and load the hand-written CUDA kernels of ``birda_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``birda_tpu_torch/_build/lib<name>-<digest>.so`` at first use,
then loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds). The digest covers the source, every shared header
``csrc/*.cuh`` and the flags, so an edited kernel or header rebuilds and an
unchanged one is reused. ``ptxas``'s report (registers, spill bytes and
performance warnings of each kernel; the dynamic shared memory depends on
hop and K, and the wrappers compute it) is kept beside the library as
``lib<name>-<digest>.ptxas.txt``. Nothing here runs at import: a
machine without ``nvcc`` imports the package and takes the plain PyTorch
paths for CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: Kernel sources of the package, one shared library each.
SOURCES = ("fused_logmel", "conv1d_stft")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of birda_tpu_torch build on a machine with the CUDA "
            "toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library goes: the digest covers the
    source, every ``csrc/*.cuh`` header and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def report_path(name: str) -> Path:
    """Where ``ptxas``'s report of ``csrc/<name>.cu``'s build is kept."""
    lib = library_path(name)
    return lib.with_name(f"{lib.stem}.ptxas.txt")


def ptxas_summary(name: str, report: str) -> list[dict]:
    """One record per kernel function in a ``ptxas -v`` report of
    ``csrc/<name>.cu``: registers at launch (``setmaxnreg`` moves more to
    the consumers later), stack and spill bytes, and the codes of the
    performance warnings (for instance C7512: wgmma serialised for want of
    registers). The function is named ``<name>_kernel<template args>``."""
    warnings: dict[str, list[str]] = {}
    for code, fn in re.findall(r"\((C\d+)\)[^\n]*?function '(\w+)'", report):
        warnings.setdefault(fn, []).append(code)
    out, current = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = {"function": _label(name, m.group(1)),
                       "registers": None, "stack_bytes": 0,
                       "spill_store_bytes": 0, "spill_load_bytes": 0,
                       "warnings": warnings.get(m.group(1), [])}
            out.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            current["stack_bytes"], current["spill_store_bytes"], \
                current["spill_load_bytes"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return out


def _label(name: str, mangled: str) -> str:
    """``<name>_kernel<int or bool template arguments>`` of a mangled
    kernel name, or the mangled name when it is not one of ours."""
    m = re.search(rf"{name}_kernelI((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return mangled
    args = [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"L([ib])(\d+)E", m.group(1))]
    return f"{name}_kernel<{', '.join(args)}>"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu (exit {r.returncode}):\n"
                f"{r.stderr}")
        report_path(name).write_text(r.stderr)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def build_all() -> None:
    """Compile every kernel source at once, one ``nvcc`` each."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        for future in [pool.submit(build, n) for n in SOURCES]:
            future.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
