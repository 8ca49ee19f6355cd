"""Build and load the port's hand-written CUDA kernels.

Each ``srl_tpu_torch/csrc/<name>.cu`` has a plain C interface. At first use
it is compiled with ``nvcc`` for Hopper (``sm_90a``) into
``build/srl_tpu_torch/lib<name>-<hash>.so`` beside the package and loaded
with ``ctypes``. The hash covers the source and the flags, so an edited
source never loads a stale library, and concurrent processes never see a
half-written one (each compiles to a temporary name and renames).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from srl_tpu_torch.utils import trace

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "srl_tpu_torch"

# IEEE sqrt and division (no --use_fast_math): the silhouettes must stay
# close to the plain PyTorch twin.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: dict = {}
# name -> {"seconds": build time (0.0 when the library was already built),
#          "log": nvcc's output, including ptxas register/spill counts}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this exact build already exists."""
    out = library_path(name)
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr}
    return out


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library, or "" when the toolkit has
    no cuobjdump."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return ""
    proc = subprocess.run([str(tool), "-sass", str(build(name))], capture_output=True,
                          text=True)
    return proc.stdout if proc.returncode == 0 else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use (the
    build and the load traced as ``kernel.load``)."""
    lib = _LOADED.get(name)
    if lib is None:
        with trace.span("kernel.load"):
            lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
