"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout
(``.gitignore`` lists ``build/``) and is loaded with ``ctypes``: the
sources have a plain C interface and include no PyTorch headers, so a
build takes seconds.  The file name carries a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: ``--fmad=false`` keeps one rounding per operation (the reference's
#: arithmetic); ``-Xptxas -v`` reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


@dataclass
class Built:
    """A compiled source: its loaded library and how the build went."""
    name: str
    path: Path
    lib: ctypes.CDLL
    seconds: float      # nvcc wall time (0.0 when the library was reused)
    log: str            # nvcc's output, the ptxas register/spill lines


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return str(path)


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` (or note the library is already built)."""
    out = _target(name)
    if out.exists():
        return out, None, time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp), time.perf_counter()


def build(*names: str) -> dict[str, Built]:
    """Compile every named source at once (one nvcc each, all started
    together), load the libraries and return them by name."""
    started = {n: _start(n) for n in names}
    built = {}
    for name, (out, job, t0) in started.items():
        log, secs = "", 0.0
        if job is not None:
            proc, tmp = job
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
        built[name] = Built(name, out, ctypes.CDLL(str(out)), secs, log)
    return built


@lru_cache(maxsize=None)
def load(name: str) -> Built:
    """The compiled library of ``csrc/<name>.cu``, built on first use."""
    return build(name)[name]
