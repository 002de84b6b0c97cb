# coding: utf-8
"""Batch synthesis API, counterpart of deepvoice3_pytorch_tpu/synthesis.py.

`tts_batch` runs texts -> waveforms on the device the parameters live on:
  1. encoder + chunked early-exit autoregressive decode
     (ops/fused_decode.py: the CUDA kernel on the card),
  2. the converter on the decoder buffers trimmed to the batch's longest
     decoded length, bucketed,
  3. Griffin-Lim (dsp/gl_cuda.py) and inverse pre-emphasis on the
     correspondingly shorter linear spectrogram.

With `mesh=` (parallel/mesh.py) the batch is data-parallel over the mesh's
"data" ranks: each runs the three stages on its rows.

On the card the results go to the host into page-locked memory
(`_pinned_to_host`).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .builder import model_decode, model_postnet
from .dsp.audio import AudioProcessor
from .parallel import mesh as mesh_lib
from .utils import profiling

# The post-decode trim keeps the batch's longest decoded length plus slack
# for the converter's receptive field, rounded up to a bucket, so every real
# frame sees the same converter context as an untrimmed run.
BUCKET_DEC_STEPS = 16
SLACK_DEC_STEPS = 8
# byte alignment of each result's view in a call's page-locked slab
SLAB_ALIGN = 256


def _round_up(n, k):
    return ((n + k - 1) // k) * k


def _prepare_batch(frontend_mod, texts, p=0.0, pad_to=None):
    seqs = [np.asarray(frontend_mod.text_to_sequence(t, p=p), np.int64)
            for t in texts]
    max_len = max(len(s) for s in seqs)
    if pad_to is not None:
        max_len = _round_up(max_len, pad_to)
    x = np.zeros((len(seqs), max_len), np.int64)
    pos = np.zeros((len(seqs), max_len), np.int64)
    lengths = np.zeros((len(seqs),), np.int64)
    for i, s in enumerate(seqs):
        x[i, :len(s)] = s
        pos[i, :len(s)] = np.arange(1, len(s) + 1)
        lengths[i] = len(s)
    return x, pos, lengths


def _param_device(params):
    return next(iter(params.parameters())).device


def speaker_id_tensor(cfg, speaker_ids, device):
    """A list or array of speaker ids -> (B,) int64 tensor on `device`, or
    None. Ids come from callers (an HTTP request's speaker_id among them),
    so they are checked here, on the host: an id out of range would index
    the speaker table out of bounds on the card."""
    if speaker_ids is None:
        return None
    ids = np.asarray(speaker_ids, np.int64).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= cfg.n_speakers):
        raise ValueError("speaker ids %s out of range for %d speaker(s)"
                         % (ids.tolist(), cfg.n_speakers))
    return torch.as_tensor(ids, device=device)


def _shard_texts(mesh, arrays, device):
    """Data-parallel batch preparation: the global batch's int arrays (the
    same pad length on every rank) with rows padded to a multiple of the
    "data" axis by repeating row 0, agreed from the mesh's first rank (a
    pronunciation mix with p > 0 draws on each rank), then this rank's
    rows."""
    n_data = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
    arrays = [a.reshape(len(a), -1) for a in arrays]
    pad = (-len(arrays[0])) % n_data
    packed = np.concatenate(arrays, axis=1)
    packed = np.concatenate([packed, np.repeat(packed[:1], pad, axis=0)])
    t = mesh_lib.broadcast_from_first(mesh, torch.from_numpy(packed).to(
        device))
    t = t[mesh_lib.shard_rows(len(t), n_data, mesh_lib.axis_rank(
        mesh, mesh_lib.DATA_AXIS))]
    out, col = [], 0
    for a in arrays:
        out.append(t[:, col:col + a.shape[1]].contiguous())
        col += a.shape[1]
    return out


def _gather_rows(mesh, tensors, lengths):
    """Every rank's rows of each (B_local, T, ...) tensor, zero-padded on
    axis 1 to `lengths[i]` and gathered over "data" in rank order."""
    group = mesh_lib.axis_group(mesh, mesh_lib.DATA_AXIS)
    out = []
    for t, n in zip(tensors, lengths):
        t = t[:, :n]
        pad = [0, 0] * (t.dim() - 2) + [0, n - t.shape[1]]
        out.append(mesh_lib.all_gather(F.pad(t, pad), group))
    return out


def _pinned_to_host(tensors):
    """Device tensors -> numpy arrays backed by one page-locked slab from
    PyTorch's caching host allocator, a view of it a tensor: every copy
    issued with non_blocking on the compute stream, one wait after the
    last, no further copy. Results that callers keep hold their slab until
    they are dropped, so no call writes into an earlier call's."""
    sizes = [t.numel() * t.element_size() for t in tensors]
    offsets = np.cumsum([0] + [_round_up(n, SLAB_ALIGN) for n in sizes])
    slab = torch.empty(int(offsets[-1]), dtype=torch.uint8, pin_memory=True)
    host = [slab[o:o + n].view(t.dtype).view(t.shape)
            for o, n, t in zip(offsets, sizes, tensors)]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


@torch.inference_mode()
def tts_batch(params, cfg, ap: AudioProcessor, frontend_mod, texts, *,
              p=0.0, speaker_ids=None, max_decoder_steps=500,
              early_exit=True, pad_to=8, mesh=None):
    """Batched text -> waveform. Returns a list of per-utterance dicts with
    waveform / mel / linear / alignment (numpy, trimmed to the decoded
    lengths) and num_decoder_steps. Runs where `params` live.
    speaker_ids: one id per text for a multi-speaker model, else None.

    mesh: data-parallel synthesis over the mesh's "data" ranks, the
    parameters replicated (whole on every rank). Every rank prepares the
    global batch, so the text pad length is global; the rows are padded to
    a multiple of the axis by repeating row 0, and each rank runs the
    encoder, kernel B1's decode, the converter and kernel B2 on its rows.
    The converter's trim is taken from the longest decoded length of the
    whole batch (all-reduced), as one process takes it, so every real frame
    sees the same converter context. Every rank returns the whole list in
    input order, the pad rows dropped, as the JAX package's
    `tts_batch(mesh=)` does. Held to the one-process call and to JAX's by
    tests/test_torch_mesh.py::test_dp_tts_batch_matches_one_process_and_jax.

    On the card the returned arrays are views of page-locked host memory,
    one slab a call sized to its six results (about 62 MB at B = 32 and
    LJSpeech lengths): a caller that keeps results keeps that much
    page-locked memory until it drops them.
    """
    with profiling.span("dv3.tts_batch") as call:
        return _tts_batch(call, params, cfg, ap, frontend_mod, texts, p,
                          speaker_ids, max_decoder_steps, early_exit, pad_to,
                          mesh)


def _tts_batch(call, params, cfg, ap, frontend_mod, texts, p, speaker_ids,
               max_decoder_steps, early_exit, pad_to, mesh):
    """tts_batch's body, its stages in spans under `call`."""
    device = _param_device(params)
    with profiling.span("dv3.tts.frontend", "host"):
        host = _prepare_batch(frontend_mod, texts, p, pad_to)
    ids = None if speaker_ids is None else np.asarray(
        speaker_ids, np.int64).reshape(-1)
    with profiling.span("dv3.tts.to_device", "host"):
        if mesh is not None:
            arrays = _shard_texts(mesh, list(host) + (
                [] if ids is None else [ids]), device)
            x, pos, lengths = arrays[0], arrays[1], arrays[2][:, 0]
            if ids is not None:
                ids = arrays[3][:, 0].cpu().numpy()
        else:
            x, pos, lengths = (torch.from_numpy(a).to(device) for a in host)
        spk = speaker_id_tensor(cfg, ids, device)

    mel, pin, align, done, dec_lengths = model_decode(
        params, cfg, x, pos, speaker_ids=spk, input_lengths=lengths,
        max_decoder_steps=max_decoder_steps, early_exit=early_exit)

    # trim the postnet input to the batch's longest decoded length before
    # the converter and vocoder: their cost follows the decoded audio
    with profiling.span("dv3.tts.sync_steps", "host"):
        n_dec_max = dec_lengths.max()
        if mesh is not None:
            n_dec_max = mesh_lib.all_reduce(
                n_dec_max.reshape(1), mesh_lib.axis_group(
                    mesh, mesh_lib.DATA_AXIS),
                op=torch.distributed.ReduceOp.MAX)
        n_dec_max = int(n_dec_max.max())
    n_bucket = min(max_decoder_steps,
                   _round_up(n_dec_max + SLACK_DEC_STEPS, BUCKET_DEC_STEPS))
    with profiling.span("dv3.tts.converter", "device"):
        linear = model_postnet(params, cfg, pin[:, :n_bucket * cfg.r],
                               speaker_ids=spk)
    with profiling.span("dv3.tts.griffin_lim", "device"):
        wav = ap.inv_spectrogram_device(linear)
    with profiling.span("dv3.tts.denormalize", "device"):
        mel = ap._denormalize(mel)
        linear = ap._denormalize(linear)
    if mesh is not None:
        time_up = getattr(cfg.converter, "time_upsampling", 1)
        n_mel = n_dec_max * cfg.r
        wav, mel, linear, align, dec_lengths, lengths = _gather_rows(
            mesh, [wav[:, :, None], mel, linear, align, dec_lengths[:, None],
                   lengths[:, None]],
            [wav.shape[1], n_mel, n_mel * time_up, n_dec_max, 1, 1])
        wav, dec_lengths, lengths = wav[..., 0], dec_lengths[:, 0], \
            lengths[:, 0]
    with profiling.span("dv3.tts.to_host", "host"):
        out = [wav, mel, linear, align, lengths, dec_lengths]
        out = _pinned_to_host(out) if wav.is_cuda else \
            [t.cpu().numpy() for t in out]
        wav_batch, mel, linear, align, lengths, dec_lengths = out

    results = []
    time_up = getattr(cfg.converter, "time_upsampling", 1)
    with profiling.span("dv3.tts.unpack", "host"):
        for i in range(len(texts)):
            n_dec = int(dec_lengths[i])
            n_mel = n_dec * cfg.r
            n_lin = n_mel * time_up
            results.append({
                "waveform": wav_batch[i][:n_lin * ap.hop_size],
                "mel": mel[i][:n_mel],
                "linear": linear[i][:n_lin],
                "alignment": align[i][:n_dec, :int(lengths[i])],
                "num_decoder_steps": n_dec,
            })
    if call:
        _record_call(call, host[0], max_decoder_steps,
                     (wav_batch, mel, linear, align, lengths, dec_lengths),
                     results)
    return results


def _record_call(call, x, steps_asked, copied, results):
    """While a window records: the call's shape as it ran (rows, padded
    text length, decoder steps asked; the benchmark holds them to the
    calls it traced), the bytes the copies to the host moved, those of
    them that landed in page-locked memory (0 on the CPU) and the bytes
    of the slices returned."""
    call.set(rows=x.shape[0], text_padded=x.shape[1],
             steps_asked=steps_asked)
    profiling.count("tts.bytes_to_host", sum(a.nbytes for a in copied))
    profiling.count("tts.bytes_pinned", sum(
        a.nbytes for a in copied if torch.from_numpy(a).is_pinned()))
    profiling.count("tts.bytes_kept", sum(
        r[k].nbytes for r in results
        for k in ("waveform", "mel", "linear", "alignment")))


def tts(params, cfg, ap, frontend_mod, text, *, p=0.0, speaker_id=None,
        max_decoder_steps=500, fast=True):
    """Single-utterance synthesis: (waveform, alignment, spectrogram, mel)."""
    speaker_ids = None if speaker_id is None else [speaker_id]
    out = tts_batch(params, cfg, ap, frontend_mod, [text], p=p,
                    speaker_ids=speaker_ids,
                    max_decoder_steps=max_decoder_steps, early_exit=fast)[0]
    return out["waveform"], out["alignment"], out["linear"], out["mel"]
