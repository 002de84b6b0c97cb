# coding: utf-8
"""The plain reference of batch synthesis, and the judge of what
`synthesis.tts_batch` returned.

For each sampled call the reference works out again, from the texts, the
speaker ids and the seeded weights alone:
  * the text ids (text.py) and their padded batch;
  * the encoder;
  * the decoder one step at a time, teacher-forced on the frames the
    program emitted: at step t it reads the program's frames 0..t-1 and
    predicts frame t, which is compared with the program's frame t. So no
    rounding feeds back and the gap stays at one step's error however long
    the decode. The monotonic attention's window follows the reference's
    own argmax; where the two best keys lie within `TIE` of each other the
    program may have taken either, and the reference takes the one whose
    next frame lies nearer the program's (as a served token is followed
    when its logit is near the best);
  * the converter on the reference's decoder states;
  * Griffin-Lim (the configuration's bf16-carry schedule) on the
    magnitudes of the program's linear spectrogram. Griffin-Lim amplifies
    bf16 roundings (two schedules part by ~5 % of the peak sample by sample
    after 16 iterations), so the waveform is judged by its spectral
    convergence against those magnitudes, over the reference's own.

`control` puts the reference in the program's place one precision lower
(TF32 for the f32 model with TF32 off, e4m3 for the bf16 Griffin-Lim) and
reads the same numbers."""

import math

import torch

from . import core
from . import deepvoice3 as dv3
from . import dsp
from . import text as text_lib
from . import conv_blocks as cb
from .attention import attention_step
from .positional import sinusoidal_encoding

# attention probabilities of the two best keys closer than this: the
# program may have latched either
TIE = 1e-3
PAD_TO = 8          # tts_batch's text pad


class precision:
    """`with precision("tf32"):` lets matmuls and cuDNN convolutions run in
    TF32; "f32" keeps both off (the configuration's float32)."""

    def __init__(self, name):
        self.tf32 = name == "tf32"

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def text_batch(texts, device):
    """(ids (B, Tk), positions (B, Tk), lengths (B,)) padded to PAD_TO."""
    seqs = [text_lib.text_to_ids(t) for t in texts]
    tk = -(-max(len(s) for s in seqs) // PAD_TO) * PAD_TO
    x = torch.zeros(len(seqs), tk, dtype=torch.int64)
    pos = torch.zeros_like(x)
    for i, s in enumerate(seqs):
        x[i, :len(s)] = torch.tensor(s)
        pos[i, :len(s)] = torch.arange(1, len(s) + 1)
    lengths = torch.tensor([len(s) for s in seqs])
    return x.to(device), pos.to(device), lengths.to(device)


def _step(params, cfg, kv, w_query, se, mask, state, x_t, la):
    """One decoder step at last_attended `la` (B, n_layers): (new state,
    frame (B, in*r), mean alignment, decoder state (B, C), per-layer
    alignments {layer: (B, Tk)})."""
    table = params["embed_query_positions"]["w"]
    fpe = sinusoidal_encoding((state["pos"] + 1)[:, None], table,
                              w_query)[:, 0]
    pre, x = cb.stack_step(params["prenet"], cfg.prenet_specs,
                           state["prenet"], x_t, speaker_embed=se)
    convs, aligns = [], {}
    for idx, (p_conv, spec, p_attn, attn_spec) in enumerate(zip(
            params["convs"], cfg.conv_specs,
            dv3.attention_params(params, cfg), cfg.attention_specs)):
        residual = x
        st, x = cb.spec_step(p_conv, spec, state["convs"][idx], x,
                             speaker_embed=se)
        convs.append(st)
        if attn_spec is not None:
            mono = cfg.force_monotonic_attention[idx]
            keys_i, values_i = kv[idx]
            x, align = attention_step(
                p_attn, attn_spec, x + fpe, keys_i, values_i, mask=mask,
                last_attended=la[:, idx] if mono else None)
            aligns[idx] = align
        x = (x + residual) * dv3.SQRT_HALF
    w_last = core.conv1d_weight(params["last_conv"])[0]
    y = x @ w_last + params["last_conv"]["b"]
    ave = sum(aligns.values()) / len(aligns)
    return ({"prenet": pre, "convs": convs, "pos": state["pos"] + 1},
            torch.sigmoid(y), ave, x, aligns)


def _pick(use_alt, a, b):
    if a is None:
        return None
    if isinstance(a, (list, tuple)):
        return [_pick(use_alt, u, v) for u, v in zip(a, b)]
    if isinstance(a, dict):
        return {k: _pick(use_alt, a[k], b[k]) for k in a}
    return torch.where(use_alt.reshape((-1,) + (1,) * (a.dim() - 1)), b, a)


def teacher_forced(tree, cfg, x, pos, lengths, spk, frames):
    """The decoder over the program's frames (B, N, in*r), each step fed
    the program's previous frame. Returns (predicted frames (B, N, in*r),
    mean alignments (B, N, Tk), decoder states (B, N, C), windows taken
    from the program's side of a tie)."""
    dcfg = cfg.decoder
    se = None if spk is None else core.embedding_apply(
        tree["embed_speakers"], spk)
    enc = dv3.encoder_apply(tree["encoder"], cfg.encoder, x,
                            speaker_embed=se)
    params = tree["decoder"]
    kv, w_query = dv3.decoder_precompute(params, dcfg, enc,
                                         text_positions=pos,
                                         speaker_embed=se)
    B, N, _ = frames.shape
    mask = core.get_mask_from_lengths(lengths, x.shape[1])
    state = dv3.decoder_init_state(dcfg, B, x.device)
    del state["last_attended"]
    n_layers = len(dcfg.convolutions)
    la = torch.zeros(B, n_layers, dtype=torch.int64, device=x.device)
    la_alt = la
    x_t = torch.zeros(B, dcfg.in_dim * dcfg.r, device=x.device)
    mono = [i for i, a in enumerate(dcfg.attention)
            if a and dcfg.force_monotonic_attention[i]]
    # every way the program may have latched the tied windows: each
    # non-empty subset of the monotonic layers taken on its second key
    subsets = [[m for j, m in enumerate(mono) if k >> j & 1]
               for k in range(1, 1 << len(mono))]
    outs, aves, states, followed = [], [], [], 0
    for t in range(N):
        new = _step(params, dcfg, kv, w_query, se, mask, state, x_t, la)
        if bool((la_alt != la).any()):
            best = (new[1] - frames[:, t]).abs().amax(dim=1)
            for layers in subsets:
                la_try = la.clone()
                la_try[:, layers] = la_alt[:, layers]
                rows = (la_try != la).any(dim=1)
                if not bool(rows.any()):
                    continue
                alt = _step(params, dcfg, kv, w_query, se, mask, state, x_t,
                            la_try)
                d = (alt[1] - frames[:, t]).abs().amax(dim=1)
                use = rows & (d < best)
                followed += int(use.sum())
                new = _pick(use, new, alt)
                la = torch.where(use[:, None], la_try, la)
                best = torch.where(use, d, best)
        state, y, ave, h, aligns = new
        outs.append(y)
        aves.append(ave)
        states.append(h)
        la_alt = la.clone()
        la = la.clone()
        for idx in mono:
            top = torch.topk(aligns[idx], 2, dim=-1)
            la[:, idx] = top.indices[:, 0]
            near = top.values[:, 0] - top.values[:, 1] < TIE
            la_alt[:, idx] = torch.where(near, top.indices[:, 1],
                                         top.indices[:, 0])
        x_t = frames[:, t]
    return (torch.stack(outs, 1), torch.stack(aves, 1),
            torch.stack(states, 1), followed)


def converter(tree, cfg, states, spk):
    """Decoder states (B, N, C) -> normalized linear (B, N r up, F)."""
    se = None if spk is None else core.embedding_apply(
        tree["embed_speakers"], spk)
    B, N, C = states.shape
    return dv3.converter_apply(tree["converter"], cfg.converter,
                               states.reshape(B, N * cfg.r, C // cfg.r),
                               speaker_embed=se)


def _norm(db, hp):
    return (db - hp["min_level_db"]) / -hp["min_level_db"]


def program_arrays(results, device):
    """tts_batch's per-utterance numpy results -> stacked tensors: mel and
    linear (dB), alignments padded to the longest text, waveforms."""
    mel = torch.stack([torch.as_tensor(r["mel"]) for r in results])
    lin = torch.stack([torch.as_tensor(r["linear"]) for r in results])
    wav = torch.stack([torch.as_tensor(r["waveform"]) for r in results])
    tk = max(r["alignment"].shape[1] for r in results)
    al = torch.zeros(len(results), mel.shape[1], tk)
    for i, r in enumerate(results):
        a = torch.as_tensor(r["alignment"])
        al[i, :a.shape[0], :a.shape[1]] = a
    return (mel.to(device), lin.to(device), al.to(device), wav.to(device))


def shape_faults(results, texts, n_steps, hp, up):
    """Lengths that must hold exactly: the decoded steps the traffic set,
    the frames and samples that follow from them, and the text length the
    alignment spans (the frontend's ids, EOS included)."""
    n = 0
    for r, t in zip(results, texts):
        n += int(r["num_decoder_steps"] != n_steps)
        n += int(r["mel"].shape[0] != n_steps)
        n += int(r["linear"].shape[0] != n_steps * up)
        n += int(r["waveform"].shape[0] != n_steps * up * hp["hop_size"])
        n += int(r["alignment"].shape[1] != len(text_lib.text_to_ids(t)))
    return n


def judge_call(tree, cfg, hp, texts, speaker_ids, n_steps, results, device,
               model_precision="f32", gl_carry="bf16"):
    """The numbers compared for one tts_batch call. With the defaults the
    reference judges the program's results; `control` passes the lower
    precisions instead and is judged against the defaults' reference."""
    up = cfg.converter.time_upsampling
    faults = shape_faults(results, texts, n_steps, hp, up)
    if faults:
        return {"shape_faults": faults}
    mel_db, lin_db, al, wav = program_arrays(results, device)
    x, pos, lengths = text_batch(texts, device)
    spk = None if speaker_ids is None else torch.as_tensor(
        speaker_ids, device=device)
    frames = _norm(mel_db, hp).reshape(mel_db.shape[0], n_steps, -1)
    with torch.no_grad(), precision("f32"):
        ref = teacher_forced(tree, cfg, x, pos, lengths, spk, frames)
        ref_lin = converter(tree, cfg, ref[2], spk)
    out = {"shape_faults": 0}
    if model_precision == "f32":
        cand_frames, cand_al, cand_lin = frames, al, _norm(lin_db, hp)
        followed = ref[3]
    else:
        with torch.no_grad(), precision(model_precision):
            low = teacher_forced(tree, cfg, x, pos, lengths, spk, frames)
            cand_lin = converter(tree, cfg, low[2], spk)
        cand_frames, cand_al, followed = low[0], low[1], low[3]
    tk = al.shape[2]
    out["frame_gap"] = float((cand_frames - ref[0]).abs().max())
    out["align_gap"] = float((cand_al[..., :tk] - ref[1][..., :tk])
                             .abs().max())
    out["linear_gap"] = float((cand_lin - ref_lin).abs().max())
    out["windows_followed"] = followed
    # Griffin-Lim on the program's magnitudes
    S = dsp.magnitudes(lin_db, hp)
    with torch.no_grad():
        sc_prog = dsp.spectral_convergence(wav, S, hp)
        sc_ref = dsp.spectral_convergence(
            dsp.griffin_lim_run(S, hp, "bf16"), S, hp, emphasised=False)
        if gl_carry != "bf16":
            sc_prog = dsp.spectral_convergence(
                dsp.griffin_lim_run(S, hp, gl_carry), S, hp,
                emphasised=False)
    out["gl_sc_excess"] = float((sc_prog / sc_ref - 1.0).max())
    return out


def control(tree, cfg, hp, texts, speaker_ids, n_steps, results, device):
    """The control: the reference one precision below the configuration's
    in the program's place, read against the reference."""
    return judge_call(tree, cfg, hp, texts, speaker_ids, n_steps, results,
                      device, model_precision="tf32", gl_carry="fp8")


def worst(readings):
    """Per number, the worst (largest) over several calls' readings."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out
