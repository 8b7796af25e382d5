"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources in ``csrc/`` are compiled at first use into one shared library
with a plain C interface. Each ``.cu`` file compiles in its own ``nvcc``
process, all started together, then one link step makes the library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/x.cu -o x.o          (one per source)
    nvcc -shared -o librepro_torch_<hash>.so *.o

The file name carries a hash of the sources and flags, so an edited
``.cu`` rebuilds and an unchanged tree reuses the library. The build goes
to ``build/repro_torch_kernels/`` at the root of the checkout (ignored by
git), or to ``$REPRO_TORCH_BUILD_DIR``. A failed build raises with nvcc's
output. Nothing here runs when the package is imported.
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
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas=-v", f"-I{CSRC}"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None     # wall time of this process's build


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (set $NVCC or put the CUDA toolkit "
                       "on PATH); the port's kernels build with nvcc")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> Path:
    """Compile the library if this source tree has not been built yet;
    return its path."""
    global build_seconds
    out = build_dir()
    lib = out / f"librepro_torch_{_digest()}.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        log = _run_all([[nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(_sources(), objs)])
        part = Path(tmp) / lib.name
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(part),
                          *map(str, objs)]])
        os.replace(part, lib)
    build_seconds = time.perf_counter() - t0
    (out / "build.log").write_text(log)          # ptxas register/smem use
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        lib = load()
        lib.rt_error_string.restype = ctypes.c_char_p
        lib.rt_error_string.argtypes = [ctypes.c_int]
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
