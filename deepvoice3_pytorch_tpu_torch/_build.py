# coding: utf-8
"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into `build/kernels/<name>-<hash>.so` next to the package by
`compile_cached`, the port's one cached-build rule (`native/` builds its
host library with it too), then loaded with ctypes. The sources have a plain
C interface and include no PyTorch header, so a build takes seconds. Every C
entry point returns `cudaGetLastError()` after its launches; `Kernel.check`
raises on a non-zero code.
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


def compile_cached(out_dir, stem, argv, deps):
    """Run `argv -o <file>` unless out_dir/<stem>-<hash>.so exists. The hash
    covers argv[1:] and the deps' contents: an edit rebuilds, an unchanged
    tree reuses the library. argv[0] is the compiler or a function that finds
    it, called only to build. The compiler writes a file of this process's
    own, renamed into place, so no caller loads a half-written library.
    Returns (path, compiler output, empty if the library existed)."""
    args = [str(a) for a in argv[1:]]
    digest = hashlib.sha1(" ".join(args).encode())
    for dep in deps:
        digest.update(dep.name.encode())
        digest.update(dep.read_bytes())
    out = Path(out_dir) / ("%s-%s.so" % (stem, digest.hexdigest()[:16]))
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
    compiler = argv[0]() if callable(argv[0]) else argv[0]
    try:
        res = subprocess.run([compiler, *args, "-o", str(tmp)],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError("cannot run %s: %s" % (compiler, e)) from e
    if res.returncode != 0:
        raise RuntimeError("%s failed on %s:\n%s%s"
                           % (compiler, stem, res.stdout, res.stderr))
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def build(source):
    """Compile csrc/<source> if needed: compile_cached's (path, output)."""
    src = CSRC / source
    return compile_cached(BUILD_DIR, src.stem, [_nvcc, *NVCC_FLAGS, src],
                          [src] + sorted(CSRC.glob("*.cuh")))


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
