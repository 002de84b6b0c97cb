# coding: utf-8
"""An audit of the PyTorch port's coverage of the JAX package, read from the
sources with `ast` (no module of either package is imported by the audit):
for every public top-level function and class, and every public method
(and `__init__`) of a public class, of each module of
`deepvoice3_pytorch_tpu/`, the counterpart module of
`deepvoice3_pytorch_tpu_torch/` (the same relative path, or the one
`COUNTERPART` names) defines the name and takes each of its arguments by
the same name. The only exceptions are the entries of `EXCEPTIONS`, each
with its reason; an entry no module needs any more fails
`test_every_exception_is_needed`.

Also: `import deepvoice3_pytorch_tpu_torch` exposes the JAX package's
top-level names and imports neither jax nor the JAX package (checked in a
fresh interpreter, since this test process imports both).
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import NamedTuple

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "deepvoice3_pytorch_tpu"
PORT_PKG = REPO / "deepvoice3_pytorch_tpu_torch"

# JAX module -> the port's module where it is not at the same path
COUNTERPART = {
    "dsp/gl_pallas.py": "dsp/gl_cuda.py",        # kernel B2
    "ops/conv_pallas.py": "ops/conv_cuda.py",    # kernel B3
}


class Skip(NamedTuple):
    reason: str


class Renamed(NamedTuple):
    to: str         # the port's argument in its place, which it must take
    reason: str


PALLAS = ("a Pallas / TPU internal (VMEM sizing, block choice) with no "
          "counterpart on the card; ")
XLA = "an XLA lowering knob; the port runs eagerly: "
INTERPRET = Skip("Pallas interpret mode; the port's kernels run on CUDA "
                 "tensors, their plain versions on CPU tensors")
FUSED = Skip("JAX picks XLA's scan or the Pallas kernel; the port always "
             "decodes through kernel B1 (its plain version on the CPU)")
DTYPE = Skip("parameters are made in f32, JAX's default; the port's tree is "
             "an nn.Module, cast with `.to(dtype)`")
STEP_TIMER = Skip("its interval counted checkpoint saves and evals as step "
                  "time; cli.train reports steps/s from its steady clock, "
                  "which leaves them out")
STATE_DTYPE = Skip("the port's decode state takes `device`; the plain step "
                   "promotes the zero state to its inputs' dtype")

# (JAX module, name, argument or None) -> Skip or Renamed. "*" as the module
# or name matches any; an argument of None excuses the name itself.
EXCEPTIONS = {
    # renames the port made
    ("*", "*", "rng"): Renamed(
        "generator", "jax.random keys become torch.Generators"),
    ("streaming.py", "StreamEmitter.__init__", "spk"): Renamed(
        "speaker_ids", "the port names speaker ids as its builders do"),
    ("ops/core.py", "glu", "axis"): Renamed("dim", "torch's name"),
    ("dsp/stft.py", "griffin_lim", "matmul_dtype"): Renamed(
        "carry", "one switch, bf16 or f32, picks both the products' and "
        "the carry's type (the two schedules the JAX callers run)"),
    ("dsp/stft.py", "griffin_lim", "carry_dtype"): Renamed(
        "carry", "as matmul_dtype"),
    ("ops/core.py", "conv_lowering", None): Skip(
        XLA + "the port's counterpart is `conv_mode` ('library' | "
        "'kernel')"),
    ("ops/core.py", "conv_lowering.__init__", None): Skip(
        "see conv_lowering"),
    ("ops/core.py", "current_conv_mode", None): Skip(
        XLA + "`conv_mode` holds the port's mode"),
    ("dsp/gl_pallas.py", "griffin_lim_pallas", None): Skip(
        "kernel B2's wrapper is `gl_cuda.griffin_lim`"),
    ("ops/conv_pallas.py", "conv1d_pallas", None): Skip(
        "kernel B3's wrapper is `conv_cuda.conv1d_taps`; off its contract "
        "it raises, and `core.conv1d_apply` routes such calls"),
    ("ops/fused_decode.py", "fused_decode_chunked", None): Skip(
        "the port's `fused_decode(early_exit=True, chunk=)`"),
    ("ops/fused_decode.py", "fused_decode", "*"): Skip(
        "the port's `fused_decode` takes the family's `fused_decode_inputs` "
        "dict whole (`inputs`: projected_kv, fpe_table, w_query, "
        "speaker_bias, fpe_raw)"),
    # Pallas and XLA internals
    ("ops/fused_decode.py", "vmem_bytes_estimate", None): Skip(
        PALLAS + "B1's shared-memory placement is `b1_layout`"),
    ("dsp/gl_pallas.py", "vmem_bytes_estimate", None): Skip(PALLAS),
    ("dsp/gl_pallas.py", "fits_vmem", None): Skip(
        PALLAS + "B2's framing rule is `gl_cuda.b2_takes`"),
    ("dsp/gl_pallas.py", "auto_block_items", None): Skip(
        PALLAS + "B2's tiles are `gl_cuda.gl_plan`'s"),
    ("*", "*", "interpret"): INTERPRET,
    ("*", "*", "precision"): Skip(
        XLA + "matmul precision; the port's f32 products are full f32 "
        "(`core.strict_numerics` turns TF32 off)"),
    ("*", "*", "fused"): FUSED,
    ("training/trainer.py", "resolve_conv_mode", None): Skip(
        XLA + "Pallas gives way to tapsum under sequence parallelism in "
        "JAX; the port's step runs B3 there through halo exchanges"),
    ("dsp/stft.py", "rdft", None): Skip(
        XLA + "the DFT as MXU matmuls; the port's STFT is torch.fft and "
        "B2 holds its own DFT operands (`gl_cuda.gl_mats`)"),
    ("dsp/stft.py", "irdft", None): Skip("see rdft"),
    ("dsp/lws_phase.py", "lws_run", "mats"): Skip(
        "the DFT matrices of rdft / irdft, which the port does not use"),
    ("parallel/mesh.py", "make_mesh", "devices"): Skip(
        "jax.devices(); the port's mesh is over the ranks of a "
        "torch.distributed group (`group=`)"),
    # models: init dtypes, decode state
    ("*", "encoder_init", "dtype"): DTYPE,
    ("*", "decoder_init", "dtype"): DTYPE,
    ("*", "converter_init", "dtype"): DTYPE,
    ("ops/core.py", "*", "dtype"): DTYPE,
    ("ops/attention.py", "attention_init", "dtype"): DTYPE,
    ("ops/conv_blocks.py", "spec_init", "dtype"): DTYPE,
    ("ops/conv_blocks.py", "stack_init", "dtype"): DTYPE,
    ("*", "decoder_init_state", "dtype"): STATE_DTYPE,
    ("ops/conv_blocks.py", "spec_init_state", "dtype"): STATE_DTYPE,
    ("ops/conv_blocks.py", "stack_init_state", "dtype"): STATE_DTYPE,
    ("ops/attention.py", "attention_apply", "projected"): Skip(
        "the port's attention_apply always takes projected keys and "
        "values; its callers project them (`project_keys_values`)"),
    ("models/decode.py", "decode_scan", None): Skip(
        "JAX's lax.scan loop; the port's loop is ops/fused_decode's host "
        "loop, over kernel B1 or its plain version, teacher-forced too"),
    ("models/decode.py", "decode_while", None): Skip("see decode_scan"),
    ("ops/positional.py", "sinusoidal_encode_table", None): Skip(
        "not called in the JAX package; the port's kernel B1 and nyanko's "
        "`fused_decode_inputs` apply the rate and sin/cos to the rows"),
    # DSP and host library
    ("dsp/audio.py", "AudioProcessor.window", None): Skip(
        "a jnp array on the default device; the port keeps the host array "
        "`window_np` and moves it to each call's device"),
    ("dsp/audio.py", "AudioProcessor.mel_filters", None): Skip(
        "as window: `mel_filters_np`"),
    ("native/__init__.py", "is_available", None): Skip(
        "the port's host library is built on first use or raises (`load`); "
        "nothing degrades to another backend"),
    ("dsp/reference_model.py", "*", None): Skip(
        "the numpy golden model the tests import from the JAX package; the "
        "port keeps only the consistency kernels its LWS needs"),
    # tracing
    ("utils/profiling.py", "StepTimer", None): STEP_TIMER,
    ("utils/profiling.py", "StepTimer.__init__", None): STEP_TIMER,
    ("utils/profiling.py", "StepTimer.tick", None): STEP_TIMER,
    ("utils/profiling.py", "StepTimer.seconds_per_step", None): STEP_TIMER,
    ("utils/profiling.py", "StepTimer.steps_per_second", None): STEP_TIMER,
    ("utils/profiling.py", "StepTimer.report", None): STEP_TIMER,
}


class Func(NamedTuple):
    args: tuple          # every argument name, positional or keyword
    var_kw: bool         # takes **kwargs


def _func(node):
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return Func(tuple(n for n in names if n not in ("self", "cls")),
                a.kwarg is not None)


def public_api(path):
    """{name: Func or None (a class)} of a module's public top-level
    functions and classes and their public methods and __init__, as
    "Class.method"."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _func(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (
                        not sub.name.startswith("_")
                        or sub.name == "__init__"):
                    out[node.name + "." + sub.name] = _func(sub)
    return out


def top_level_names(path):
    """Names a module binds at top level: definitions, imports and
    assignments (a name the port re-exports counts as defined)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return names


def _exception(module, name, arg):
    for key in ((module, name, arg), (module, "*", arg), ("*", name, arg),
                ("*", "*", arg)):
        if key in EXCEPTIONS:
            return key, EXCEPTIONS[key]
    if arg is not None:
        key = (module, name, "*")
        if key in EXCEPTIONS:
            return key, EXCEPTIONS[key]
    return None, None


def audit(module):
    """(gaps, exception keys used) of one JAX module against its
    counterpart."""
    jax_path = JAX_PKG / module
    port_path = PORT_PKG / COUNTERPART.get(module, module)
    if not port_path.exists():
        return ["no counterpart module %s" % port_path.relative_to(REPO)], \
            set()
    want, have = public_api(jax_path), public_api(port_path)
    bound = top_level_names(port_path)
    gaps, used = [], set()
    for name, fn in want.items():
        if name not in have and not ("." not in name and name in bound):
            key, exc = _exception(module, name, None)
            if exc is None:
                gaps.append("%s: %s is missing" % (module, name))
            used.add(key)
            continue
        got = have.get(name)
        if fn is None or got is None or got.var_kw:
            continue
        for arg in fn.args:
            if arg in got.args:
                continue
            key, exc = _exception(module, name, arg)
            if exc is None:
                gaps.append("%s: %s does not take %r" % (module, name, arg))
            elif isinstance(exc, Renamed) and exc.to not in got.args:
                gaps.append("%s: %s takes neither %r nor its rename %r"
                            % (module, name, arg, exc.to))
            used.add(key)
    return gaps, used


MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_port_covers_module(module):
    gaps, _ = audit(module)
    assert not gaps, "\n".join(gaps)


def test_every_exception_is_needed():
    used = set()
    for module in MODULES:
        used |= audit(module)[1]
    stale = sorted(k for k in EXCEPTIONS if k not in used)
    assert not stale, "exceptions no module needs any more: %s" % stale
    assert all(e.reason.strip() for e in EXCEPTIONS.values())


def test_package_exports_without_jax():
    """The JAX package's top-level names on the port's package, imported in
    a fresh interpreter: jax and the JAX package stay out of sys.modules,
    no CUDA context is made and `tts_stream` imports `streaming` only when
    called."""
    want = sorted(n for n in top_level_names(JAX_PKG / "__init__.py")
                  if not n.startswith("_"))
    code = textwrap.dedent("""
        import sys
        import deepvoice3_pytorch_tpu_torch as pkg
        import torch
        want = %r
        missing = [n for n in want if not hasattr(pkg, n)]
        assert not missing, missing
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "deepvoice3_pytorch_tpu"
               or m.startswith("deepvoice3_pytorch_tpu.")]
        assert not bad, bad
        assert "deepvoice3_pytorch_tpu_torch.streaming" not in sys.modules
        assert not torch.cuda.is_initialized()
        assert callable(pkg.tts_stream) and callable(pkg.model_synthesize)
        print("OK")
    """) % (want,)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-2000:]
    assert {"builder", "TTSModelConfig", "deepvoice3", "nyanko",
            "deepvoice3_multispeaker", "model_init", "model_forward",
            "model_synthesize", "tts_stream"} <= set(want)
