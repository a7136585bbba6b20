"""Build of the port's CUDA kernels.

The sources under ``ops/csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the
kernel wrappers load with ``ctypes``.  No PyTorch header is included,
so the build takes seconds.  The library lands in ``build/`` beside the
package (``HOROVOD_TPU_TORCH_BUILD_DIR`` overrides it), named by a hash
of its sources, and is built at first use.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
#: per library: {"seconds": build time (0.0 when found built),
#: "log": nvcc's output, "path": the .so}
build_info = {}


def build_dir() -> Path:
    env = os.environ.get("HOROVOD_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of horovod_tpu_torch cannot be built")


def load(name: str, sources) -> ctypes.CDLL:
    """Build (once per source hash) and load ``lib<name>.so`` from
    ``sources`` (file names under ``ops/csrc``).  nvcc runs outside the
    lock, so libraries called for from several threads build at once."""
    with _lock:
        if name in _libs:
            return _libs[name]
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256()
    for p in paths:
        digest.update(p.read_bytes())
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{name}-{digest.hexdigest()[:12]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.monotonic() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {so.name}:\n"
                f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, so)
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(so))
            build_info[name] = {"seconds": seconds, "log": log,
                                "path": str(so)}
        return _libs[name]
