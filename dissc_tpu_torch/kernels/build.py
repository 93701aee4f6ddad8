"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The library lands in
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, so a changed source is rebuilt and an unchanged one
is reused.  Nothing is built when a module is imported: a kernel's
wrapper calls :func:`load` at its first launch.  :func:`shared_library`
builds the native C++ data libraries the same way
(:mod:`dissc_tpu_torch.data.native_build`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels are built from source at first use")
    return path


def shared_library(src: Path, cmd: Sequence[str], build_dir: Path,
                   after_src: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``src`` with ``[*cmd, -o <lib>, src, *after_src]`` into
    ``build_dir`` (the library named by a hash of the source and the command
    line, so a changed source is rebuilt) and load it; raises
    ``RuntimeError`` if the compiler cannot be run, fails, or the library
    cannot be loaded."""
    flags = " ".join([*cmd[1:], *after_src])
    digest = hashlib.sha256(src.read_bytes() + flags.encode()).hexdigest()
    target = Path(build_dir) / f"lib{src.stem}-{digest[:16]}.so"
    if not target.exists():
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        try:
            done = subprocess.run([*cmd, "-o", str(tmp), str(src), *after_src],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        except OSError as err:
            raise RuntimeError(f"cannot run {cmd[0]!r} to build {src.name}: {err}") from err
        if done.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed for {src.name}:\n"
                               f"{done.stdout.decode(errors='replace')}")
        os.replace(tmp, target)
    try:
        return ctypes.CDLL(str(target))
    except OSError as err:
        raise RuntimeError(f"cannot load {target}: {err}") from err


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = shared_library(CSRC / f"{name}.cu", [_nvcc(), *NVCC_FLAGS], BUILD_DIR)
        _loaded[name] = lib
    return lib
