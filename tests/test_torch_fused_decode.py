# coding: utf-8
"""Decode parity of the PyTorch port against the JAX package's fused Pallas
decoder (run in interpret mode on the CPU, as tests/test_fused_decode.py
does). On the CPU the port's `fused_decode` takes its plain version, the
eager decode loop over `make_decoder_step`, so this pins the semantics the
CUDA kernel is held to on the card. Bars: frames, alignments, done and
decoder states <= 2e-5 (tests/test_fused_decode.py's fused-vs-scan bar),
last_attended and lengths exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu.models import deepvoice3 as j_dv3
from deepvoice3_pytorch_tpu.ops import fused_decode as j_fd
from deepvoice3_pytorch_tpu_torch.models import deepvoice3 as t_dv3
from deepvoice3_pytorch_tpu_torch.ops import core as t_core
from deepvoice3_pytorch_tpu_torch.ops import fused_decode as t_fd

from torch_port_common import (jax_params, maxdiff, port_params, t,
                               text_inputs, tiny_configs)

TOL = 2e-5


def _setup(fc_bias=0.0, **kw):
    cfg_j, cfg_t = tiny_configs(**kw)
    pj = jax_params(cfg_j)
    pj["decoder"]["fc"]["b"] = pj["decoder"]["fc"]["b"] + fc_bias
    pt = port_params(pj, cfg_t)
    x, pos, lengths = text_inputs()
    enc_j = j_dv3.encoder_apply(pj["encoder"], cfg_j.encoder, jnp.asarray(x))
    enc_t = t_dv3.encoder_apply(pt["encoder"], cfg_t.encoder, t(x))
    assert maxdiff(enc_t[0], enc_j[0]) <= 1e-5
    return cfg_j, cfg_t, pj, pt, enc_j, enc_t, pos, lengths


@pytest.mark.parametrize("monotonic,use_lengths", [
    (True, True), (False, True), (True, False)])
def test_decode_matches_jax_fused(monotonic, use_lengths):
    cfg_j, cfg_t, pj, pt, enc_j, enc_t, pos, lengths = _setup(
        force_monotonic_attention=monotonic)
    T = 11
    out_j = j_dv3.decoder_decode(
        pj["decoder"], cfg_j.decoder, enc_j, jnp.asarray(pos),
        lengths=jnp.asarray(lengths) if use_lengths else None,
        max_decoder_steps=T, early_exit=False, fused=True)
    out_t = t_dv3.decoder_decode(
        pt["decoder"], cfg_t.decoder, enc_t, t(pos),
        lengths=t(lengths) if use_lengths else None,
        max_decoder_steps=T, early_exit=False)
    for name in ("outputs", "alignments", "done", "decoder_states"):
        d = maxdiff(getattr(out_t, name), getattr(out_j, name))
        assert d <= TOL, (name, d)
    assert (out_t.lengths.numpy() == np.asarray(out_j.lengths)).all()
    assert out_t.num_steps == int(out_j.num_steps) == T


def test_last_attended_carry_exact():
    """The port's last_attended after the decode equals the JAX kernel's
    carry-out exactly (first-argmax tie-breaking included)."""
    cfg_j, cfg_t, pj, pt, enc_j, enc_t, pos, lengths = _setup()
    T = 11
    fi_j = j_dv3.fused_decode_inputs(pj["decoder"], cfg_j.decoder, enc_j,
                                     jnp.asarray(pos), T)
    mask_j = jnp.arange(12)[None, :] >= jnp.asarray(lengths)[:, None]
    prep = j_fd._Prepared(pj["decoder"], cfg_j.decoder, fi_j["projected_kv"],
                          mask_j, w_query=fi_j["w_query"], speaker_bias=None,
                          fpe_raw=True)
    la0, bufs0 = prep.zero_carry()
    init = jnp.zeros((3, cfg_j.decoder.in_dim), jnp.float32)
    (o_j, _, _, _), (_, la_j, _) = prep.launch(fi_j["fpe_table"], init, la0,
                                               bufs0, T, True)

    fi_t = t_dv3.fused_decode_inputs(pt["decoder"], cfg_t.decoder, enc_t,
                                     t(pos))
    out = t_fd.fused_decode(
        pt["decoder"], cfg_t.decoder, fi_t,
        t_core.get_mask_from_lengths(t(lengths), 12),
        torch.zeros(3, cfg_t.decoder.in_dim), T,
        cfg_t.decoder.min_decoder_steps, early_exit=False)
    assert maxdiff(out.outputs, o_j) <= TOL
    assert (out.last_attended.numpy() == np.asarray(la_j)).all()


@pytest.mark.parametrize("chunk,fc_bias", [(4, 0.0), (5, 0.0), (32, 0.0),
                                           (4, 100.0), (3, -2.0)])
def test_chunked_early_exit_matches_jax(chunk, fc_bias):
    """Chunked early exit against `fused_decode_chunked`: same frames, the
    same number of computed steps and exact per-sample lengths. fc_bias
    +100 makes every done flag fire at once (the loop stops after the first
    chunk past min_decoder_steps)."""
    cfg_j, cfg_t, pj, pt, enc_j, enc_t, pos, lengths = _setup(fc_bias=fc_bias)
    T = 23
    min_steps = 2
    fi_j = j_dv3.fused_decode_inputs(pj["decoder"], cfg_j.decoder, enc_j,
                                     jnp.asarray(pos), T)
    mask_j = jnp.arange(12)[None, :] >= jnp.asarray(lengths)[:, None]
    init_j = jnp.zeros((3, cfg_j.decoder.in_dim), jnp.float32)
    o_j, a_j, d_j, s_j, n_j = j_fd.fused_decode_chunked(
        pj["decoder"], cfg_j.decoder, fi_j["projected_kv"],
        fi_j["fpe_table"], mask_j, init_j, T, min_steps, chunk=chunk,
        w_query=fi_j["w_query"], fpe_raw=True, interpret=True)

    fi_t = t_dv3.fused_decode_inputs(pt["decoder"], cfg_t.decoder, enc_t,
                                     t(pos))
    out = t_fd.fused_decode(
        pt["decoder"], cfg_t.decoder, fi_t,
        t_core.get_mask_from_lengths(t(lengths), 12),
        torch.zeros(3, cfg_t.decoder.in_dim), T, min_steps,
        early_exit=True, chunk=chunk)
    assert out.num_steps == int(n_j)
    if fc_bias > 0:
        assert out.num_steps < T
    for name, a, b in (("outputs", out.outputs, o_j),
                       ("alignments", out.alignments, a_j),
                       ("done", out.done, d_j),
                       ("decoder_states", out.decoder_states, s_j)):
        d = maxdiff(a, b)
        assert d <= TOL, (name, d)
    from deepvoice3_pytorch_tpu.models import decode as j_decode
    from deepvoice3_pytorch_tpu_torch.models import decode as t_decode
    len_j = j_decode._length_from_done(d_j, min_steps, n_j)
    len_t = t_decode._length_from_done(out.done, min_steps, out.num_steps)
    assert (len_t.numpy() == np.asarray(len_j)).all()


class _RecordingDecoder:
    """The launch-and-carry interface of `PlainDecoder` over no model: each
    launch appends its (t0, steps) to `launches`, checks the carry
    follows on, and writes done = 1 at frame `fire` (None: never)."""

    fire = None
    launches = []

    def __init__(self, params, cfg, inputs, mask, n_steps):
        self.B, self.tk, self.C, self.out_dim = 2, 3, 4, 5
        self.n_steps = n_steps
        self.device, self.dtype = torch.device("cpu"), torch.float32
        type(self).launches = []

    new_outputs = t_fd._Decoder.new_outputs

    def zero_carry(self, initial_input):
        return {"t": 0}

    def last_attended(self, carry):
        return torch.full((self.B, 1), carry["t"], dtype=torch.int32)

    def launch(self, carry, outputs, t0, steps, trace=None):
        assert trace is None and carry["t"] == t0 and steps > 0
        assert t0 + steps <= min(outputs[0].shape[1], self.n_steps)
        self.launches.append((t0, steps))
        for buf in outputs:
            buf[:, t0:t0 + steps] = 1.0 + torch.arange(
                t0, t0 + steps, dtype=buf.dtype).view(
                    1, -1, *[1] * (buf.dim() - 2))
        outputs[2][:, t0:t0 + steps] = 0.0
        if self.fire is not None and t0 <= self.fire < t0 + steps:
            outputs[2][:, self.fire] = 1.0
        carry["t"] = t0 + steps


@pytest.mark.parametrize("chunk", [4, 5, 32])
@pytest.mark.parametrize("max_steps", [1, 31, 32, 33, 70, 217])
@pytest.mark.parametrize("fire", [None, "early", "last"])
def test_decode_chunks_launch_only_the_steps_asked(chunk, max_steps, fire,
                                                   monkeypatch):
    """The chunk loop: ceil(N / chunk) launches, the last of the N - t0
    steps left, so the launches' steps sum to N when nothing exits early;
    early exit stops after the chunk whose frames fired the latch (the
    short last one included); num_steps is min(launches x chunk, N), as
    with whole chunks; buffers of N frames; the counters `b1.steps_run`
    and `b1.steps_kept` inside a recording window."""
    from deepvoice3_pytorch_tpu_torch.utils import profiling

    ch = min(chunk, max_steps)
    n_chunks = -(-max_steps // ch)
    want = [(c * ch, min(ch, max_steps - c * ch)) for c in range(n_chunks)]
    min_steps = 0
    at = {None: None, "early": min(ch, max_steps) - 1,
          "last": max_steps - 1}[fire]
    monkeypatch.setattr(_RecordingDecoder, "fire", at)
    with profiling.recording() as w:
        out = t_fd._decode_chunks(_RecordingDecoder, None, None, None, None,
                                  None, max_steps, min_steps,
                                  early_exit=fire is not None, chunk=chunk)
    c = n_chunks if at is None else at // ch + 1
    assert _RecordingDecoder.launches == want[:c]
    assert out.num_steps == min(c * ch, max_steps)
    if fire is None:
        assert sum(s for _, s in _RecordingDecoder.launches) == max_steps
    if fire == "last":
        assert len(_RecordingDecoder.launches) == n_chunks
    run = sum(s for _, s in _RecordingDecoder.launches)
    assert w.counters() == {"b1.steps_run": run,
                            "b1.steps_kept": out.num_steps}
    assert run == out.num_steps
    for buf in (out.outputs, out.alignments, out.done, out.decoder_states):
        assert buf.shape[:2] == (2, max_steps)
    frames = out.outputs[0, :, 0]
    assert (frames[:out.num_steps] == torch.arange(
        1, out.num_steps + 1)).all()
    assert (frames[out.num_steps:] == 0).all()
    assert (out.last_attended == out.num_steps).all()
