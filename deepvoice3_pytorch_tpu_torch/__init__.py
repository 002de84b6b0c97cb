# coding: utf-8
"""deepvoice3_pytorch_tpu_torch — the PyTorch + CUDA port of
deepvoice3_pytorch_tpu, for one NVIDIA H100.

The module layout mirrors the JAX package, so each counterpart sits at the
same relative path. Parameters are an `nn.Module` tree whose `state_dict()`
keys are the JAX pytree's key paths (`params.py`). The two hot loops of batch
synthesis run in hand-written CUDA kernels (`csrc/`, built on first use by
`_build.py`): the fused autoregressive decoder (`ops/fused_decode.py`) and
Griffin-Lim (`dsp/gl_cuda.py`). A CPU tensor takes each kernel's plain
PyTorch version instead; a CUDA tensor launches the kernel or raises.

Importing this package imports neither jax nor the JAX package.
"""

__version__ = "0.1.0"

from . import builder  # noqa: F401,E402
from .builder import (  # noqa: F401,E402
    TTSModelConfig, deepvoice3, nyanko, deepvoice3_multispeaker,
    model_forward, model_synthesize)
from .params import model_init  # noqa: F401,E402


def tts_stream(*args, **kwargs):
    """Streaming synthesis generator: streaming.tts_stream, imported on
    call."""
    from . import streaming

    return streaming.tts_stream(*args, **kwargs)
