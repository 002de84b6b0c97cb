# coding: utf-8
"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into `build/kernels/<name>-<hash>.so` next to the package (the hash covers
the sources and flags, so an edit rebuilds and an unchanged tree reuses the
library), then loaded with ctypes. The sources have a plain C interface and
include no PyTorch header, so a build takes seconds. Every C entry point
returns `cudaGetLastError()` after its launches; `Kernel.check` raises on a
non-zero code.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def build(source):
    """Compile csrc/<source> if needed. Returns (library path, compiler
    output; empty when the library was already built)."""
    src = CSRC / source
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for dep in [src] + sorted(CSRC.glob("*.cuh")):
        digest.update(dep.read_bytes())
    out = BUILD_DIR / ("%s-%s.so" % (src.stem, digest.hexdigest()[:16]))
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s%s"
                           % (src, res.stdout, res.stderr))
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


class Kernel:
    """One CUDA source: its library, loaded on first use, and a count of the
    launches its wrapper made (one per call of a C entry point), in all, by
    the wrapper's name for the call (`by_entry`) and, where the wrapper
    names one, by the route the call took (`by_route`)."""

    def __init__(self, source, signatures):
        self.source = source
        self._signatures = signatures    # name -> argtypes; restype c_int
        self._lib = None
        self.build_log = ""
        self.launches = 0
        self.by_entry = {}
        self.by_route = {}

    def launched(self, entry, route=None):
        self.launches += 1
        self.by_entry[entry] = self.by_entry.get(entry, 0) + 1
        if route is not None:
            self.by_route[route] = self.by_route.get(route, 0) + 1

    def reset_counts(self):
        self.launches = 0
        self.by_entry = {}
        self.by_route = {}

    @property
    def lib(self):
        if self._lib is None:
            path, self.build_log = build(self.source)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in self._signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dv3_error_string.argtypes = [ctypes.c_int]
            lib.dv3_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, rc, what):
        if rc != 0:
            msg = self.lib.dv3_error_string(rc).decode()
            raise RuntimeError("%s: CUDA error %d (%s)" % (what, rc, msg))
