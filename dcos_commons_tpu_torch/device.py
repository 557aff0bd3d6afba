"""Device resolution and the build of the port's CUDA kernels.

``resolve_device``: the card is the default.  ``None`` means
``cuda``; asking for CUDA on a host without it raises — nothing in the
port quietly carries on on the CPU.

Kernels are built from the sources in ``csrc/`` at first use, into
``build/kernels/`` at the repo root (listed in ``.gitignore``): ``nvcc``
compiles each ``.cu`` for ``sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes``.  The library's file name
carries a hash of its source, so an edited kernel never loads a stale
build.  The hash also covers every ``csrc/*.cuh`` (the Hopper helpers in
``hopper.cuh``), so an edited header rebuilds every library.  The bf16
attention kernels build their TMA tensor maps with the driver's
``cuTensorMapEncodeTiled``, found at run time through the runtime's
driver entry point: nothing links against ``libcuda``, but the driver
must be there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional, Union

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PKG_DIR)
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_build_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {home}/bin or on PATH: the CUDA "
            "kernels cannot be built on this host"
        )
    return found


def _library_path(name: str) -> str:
    """``build/kernels/lib<name>-<hash>.so``, the hash over the ``.cu``
    and every ``csrc/*.cuh`` it may include, so that an edit to a shared
    header never loads a stale library."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for source in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, source), "rb") as f:
            digest.update(source.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_cuda(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build every named ``csrc/<name>.cu`` (all of them when ``names``
    is None) that has no up-to-date library yet, one ``nvcc`` per
    source, all started together.  Returns name -> library path and
    raises with the compiler's output when a build fails."""
    if names is None:
        names = sorted(
            f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
        )
    paths = {name: _library_path(name) for name in names}
    with _build_lock:
        todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
        if not todo:
            return paths
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, path in todo.items():
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, name + ".cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {name}.cu failed:\n{out}")
                continue
            with open(todo[name] + ".log", "w") as f:
                f.write(out)
            # atomic publish: a concurrent process never loads a
            # half-written library
            os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def cuda_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built first if needed."""
    lib = _libraries.get(name)
    if lib is None:
        path = build_cuda([name])[name]
        with _build_lock:
            lib = _libraries.setdefault(name, ctypes.CDLL(path))
    return lib

