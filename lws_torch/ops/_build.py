"""Build the CUDA sources under lws_torch/csrc at first use and load them.

Each source is compiled by `nvcc` alone into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), cached in
lws_torch/build/ under a hash of the source, the csrc headers it includes
and the flags, and loaded with ctypes. A failed build raises; nothing
falls back.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

# -fmad=false keeps each product and sum rounded on its own, as the plain
# PyTorch version rounds them; -Xptxas -v writes the register and shared
# memory report into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("lws_torch: nvcc not found (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """csrc/<name>.cu and every file it includes with #include "...", at
    any depth, in the order first met."""
    seen = [CSRC / f"{name}.cu"]
    for path in seen:  # grows while it is walked
        for inc in _INCLUDE.findall(path.read_text()):
            dep = (path.parent / inc).resolve()
            if dep not in seen:
                seen.append(dep)
    return seen


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu lands, keyed by the source, the
    files it includes and the flags."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        key.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its build is already there."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"lws_torch: nvcc failed for {name}.cu:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build_all(names) -> dict[str, Path]:
    """Build several sources at once: one nvcc each, all started together."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]
