"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; the
compilations run side by side.  Nothing happens at import: the first
kernel launch (or an explicit :func:`build_kernels`) builds.  Libraries
are cached by a hash of their sources and flags under the build
directory: ``$OCTREE_MG_TORCH_BUILD_DIR`` or ``build/octree_mg_tpu_torch``
beside the package.

``--fmad=false`` is part of the contract, not a tuning flag: the kernels
repeat the plain PyTorch versions' arithmetic operation by operation, and
a contracted ``a*b+c`` would round differently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
SOURCES = ("stencil_sweep", "seg_sweep", "downsweep", "restrict",
           "prolong_correct", "residual_df32", "flat_sweep")
HEADERS = ("stencil_common.cuh", "stream_kernel.cuh", "stream_wide.cuh",
           "stream_faces.cuh", "apply_faces.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
#: seconds the last build took (0.0 when every library was cached)
last_build_seconds = 0.0


def build_dir() -> str:
    env = os.environ.get("OCTREE_MG_TORCH_BUILD_DIR")
    if env:
        return env
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "build", "octree_mg_tpu_torch")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "octree_mg_tpu_torch are built at first use and need "
                       "the CUDA toolkit (looked on PATH, $CUDA_HOME, "
                       "/usr/local/cuda)")


def _digest(name: str, extra_flags) -> str:
    h = hashlib.sha1()
    for fn in (name + ".cu",) + HEADERS:
        with open(os.path.join(_CSRC, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    return h.hexdigest()[:16]


def build_kernels(extra_flags=(), verbose: bool = False,
                  sources=SOURCES) -> Dict[str, str]:
    """Compile every kernel source of ``sources`` that has no cached
    library, all at once, and return {name: library path}.  Raises with
    the compiler's output if a source does not build."""
    global last_build_seconds
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    paths, procs = {}, {}
    for name in sources:
        path = os.path.join(out_dir,
                            f"lib{name}-{_digest(name, extra_flags)}.so")
        paths[name] = path
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-I", _CSRC, "-o", tmp,
               os.path.join(_CSRC, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    last_build_seconds = time.perf_counter() - t0 if procs else 0.0
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source (building all on first use)."""
    lib = _libs.get(name)
    if lib is None:
        paths = build_kernels()
        for n, p in paths.items():
            _libs.setdefault(n, ctypes.CDLL(p))
        lib = _libs[name]
    return lib
