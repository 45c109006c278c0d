"""Build `talkshow_torch/csrc/*.cu` with nvcc and load it with ctypes.

Each source compiles on first use into a shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o talkshow_torch/_build/<name>-<hash>.so csrc/<name>.cu

The output lives in `talkshow_torch/_build/` (git-ignored), keyed by a
hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source rebuilds and an unchanged one loads at once.  Nothing is
compiled or loaded at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library for this source exists."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    return build_shared(CSRC / f"{name}.cu", [nvcc_path(), *FLAGS], headers)


def build_shared(src: Path, compiler: list, extra: bytes = b"") -> Path:
    """Run `compiler -o <lib> src` into BUILD unless a library keyed by the
    hash of the source, `extra` and the command exists; raise on failure."""
    digest = hashlib.sha256(src.read_bytes() + extra
                            + " ".join(compiler[1:]).encode()).hexdigest()[:16]
    out = BUILD / f"{src.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*compiler, "-o", str(tmp), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler[0]} failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and dlopen csrc/<name>.cu; cached per process."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
