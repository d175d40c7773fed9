"""Build, load and count the port's hand-written CUDA kernels (the
counterpart of `repro/kernels/backend.py`, which decided between
compiled and interpreted Pallas).

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC` into `build/kernels/lib<name>-<hash>.so` at the repository root
(listed in `.gitignore`) the first time a kernel is launched, then
loaded with `ctypes`. The hash covers the source and the flags, so a
stale library is never reused. `build_all()` compiles every source at
once, one `nvcc` process each.

Wrappers pass device pointers as `c_void_p` and PyTorch's current
stream, and every C entry point returns `cudaGetLastError()` after its
launch; `check()` raises on anything but 0.

`LAUNCHES` holds one plain integer per kernel. A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that it went
through the kernels (`reset_launches()` before, read after).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                            "paged_decode_attention": 0,
                            "block_dots": 0, "block_combine": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin); the "
                       "CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _compile(name: str):
    """Start `nvcc` for one source; returns (process, tmp file, target)."""
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                           f"{' '.join(proc.args)}\n{log}")
    os.replace(tmp, out)     # atomic: a reader never sees a partial file


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> float:
    """Compile every kernel source that has no up-to-date library, all
    `nvcc` processes started together; returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        jobs = [_compile(n) for n in sources() if not _lib_path(n).exists()]
        try:
            for job in jobs:
                _finish(job)
        finally:
            for proc, tmp, _ in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            path = _lib_path(name)
            if not path.exists():
                _finish(_compile(name))
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
