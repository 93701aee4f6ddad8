"""Build and load the repository's native C++ data libraries (``native/*.cc``).

The JAX package builds ``native/libwavloader.so`` and ``libflacdec.so``
next to their sources and, when the build fails, quietly takes its numpy
path.  The port leaves ``native/`` untouched: it compiles each source with
``g++ -O3 -shared -fPIC -std=c++17`` into ``build/native/`` at the root of
the checkout, named by a hash of the source and the flags
(:func:`~dissc_tpu_torch.kernels.build.shared_library`, as the CUDA
kernels are built), and raises when the build or the load fails.  Nothing
is built when a module is imported: a binding calls :func:`load` at its
first use.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Sequence

from dissc_tpu_torch.kernels.build import shared_library

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()  # the prefetch thread and the loop may both reach load()


def load(name: str, link: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cc``, built first if needed;
    raises ``RuntimeError`` if it cannot be built or loaded."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = shared_library(NATIVE_SRC / f"{name}.cc", [CXX, *CXX_FLAGS], BUILD_DIR,
                                 after_src=link)
            _loaded[name] = lib
        return lib
