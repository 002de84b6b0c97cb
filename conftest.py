# coding: utf-8
"""Build both packages' host C++ libraries once, before any test collects.

The JAX package builds its `native/libdv3native.so` in place, without a
rename, on its first `is_available()`; three test modules call it while they
are collected, so xdist workers on a fresh checkout raced to write the one
file, and a worker that loaded it half-written skipped or failed the native
tests. `pytest_configure` runs on the controller before any worker starts
(and in the only process without xdist), so the workers find both libraries
built.
"""

import os
import subprocess
import sys
from pathlib import Path

# A child process builds the JAX package's library: importing that package
# here would load JAX into a run without xdist, and dv3bench's tests hold
# that process to no JAX module. Where JAX is absent the child fails alone.
_JAX_BUILD = "from deepvoice3_pytorch_tpu import native; native.is_available()"


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    from deepvoice3_pytorch_tpu_torch import native

    try:
        native.build()
    except RuntimeError:
        pass    # the tests that load the library raise the compiler's output
    subprocess.run([sys.executable, "-c", _JAX_BUILD],
                   cwd=Path(__file__).resolve().parent, capture_output=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
