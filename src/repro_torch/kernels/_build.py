"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout
(``.gitignore`` lists ``build/``) and is loaded with ``ctypes``: the
sources have a plain C interface and include no PyTorch headers, so a
build takes seconds.  The file name carries a hash of the source, of the
shared headers (``csrc/*.cuh``) and of the flags, so an edited source or
header rebuilds and an unchanged one is reused.
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
#: The matrix kernels (matmul, block-sparse FC, attention, SSD) sum in
#: another order than their plain versions anyway, so they may contract a
#: multiply and an add into one FMA.
FMAD_FLAGS = tuple(f for f in NVCC_FLAGS if f != "--fmad=false")

#: Each source's flags: the lane kernel, the closed form, the statistics
#: fold and the FIR are held bitwise against their plain versions and keep
#: one rounding per operation.
SOURCE_FLAGS = {"charge_replay": NVCC_FLAGS, "closed_form": NVCC_FLAGS,
                "fir_conv1d": NVCC_FLAGS, "stats_fold": NVCC_FLAGS,
                "dense_matmul": FMAD_FLAGS, "sparse_fc": FMAD_FLAGS,
                "flash_attention": FMAD_FLAGS, "ssd_intra": FMAD_FLAGS,
                "charge_replay_profile": NVCC_FLAGS + ("-DREPLAY_PROFILE",),
                "ssd_intra_thread_fed": FMAD_FLAGS + ("-DSSD_THREAD_FED",)}

#: Libraries built from another library's source with other flags: the
#: lane kernel's profile build (``tools/profile_replay.py``) and the SSD
#: cell's wgmma design with x dt fed by its threads' loads (timed beside
#: the TMA ring by ``chip_smoke.py``).
SOURCE_OF = {"charge_replay_profile": "charge_replay",
             "ssd_intra_thread_fed": "ssd_intra"}


def source(name: str) -> Path:
    """The ``.cu`` file that library ``name`` is built from."""
    return CSRC / f"{SOURCE_OF.get(name, name)}.cu"


@dataclass
class Built:
    """A compiled source: its loaded library and how the build went."""
    name: str
    path: Path
    lib: ctypes.CDLL
    seconds: float      # nvcc wall time (0.0 when the library was reused)
    log: str            # nvcc's output, the ptxas register/spill lines
    #                     (kept beside the library, so a reused one has it)


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
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    of every header in ``csrc`` (any source may include any of them) and
    of the flags."""
    h = hashlib.sha256(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(SOURCE_FLAGS[name]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` (or note the library is already built)."""
    out = _target(name)
    if out.exists():
        return out, None, time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *SOURCE_FLAGS[name], "-o", str(tmp),
           str(source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp), time.perf_counter()


def build(*names: str) -> dict[str, Built]:
    """Compile every named source at once (one nvcc each, all started
    together), load the libraries and return them by name."""
    started = {n: _start(n) for n in names}
    built = {}
    for name, (out, job, t0) in started.items():
        log_path, secs = out.with_suffix(".log"), 0.0
        if job is not None:
            proc, tmp = job
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source(name).name} "
                                   f"(exit {proc.returncode}):\n{log}")
            log_path.write_text(log)
            os.replace(tmp, out)
        log = log_path.read_text() if log_path.exists() else ""
        built[name] = Built(name, out, ctypes.CDLL(str(out)), secs, log)
    return built


@lru_cache(maxsize=None)
def load(name: str) -> Built:
    """The compiled library of ``csrc/<name>.cu``, built on first use."""
    return build(name)[name]
