"""Builds the port's CUDA sources into shared libraries with ``nvcc``.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own into
``build/kernels/lib<name>-<hash>.so`` at the repository root (override the
directory with ``REPRO_TORCH_BUILD_DIR``), for ``sm_90a`` (Hopper). The hash
covers the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source never loads a stale library. Nothing here runs at import: the
first wrapper call on a CUDA tensor builds.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its current library exists; returns
    the library path. ``nvcc``'s resource report (registers, shared memory,
    spills) lands beside the library as ``<lib>.so.log``."""
    path = library_path(name)
    if path.exists():
        return path
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    log = path.with_suffix(".so.log")
    with open(log, "w") as out:
        rc = subprocess.run(
            [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=out, stderr=subprocess.STDOUT).returncode
    if rc:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {rc}, see {log})")
    os.replace(tmp, path)
    return path
