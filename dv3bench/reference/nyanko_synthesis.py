# coding: utf-8
"""The judge of what `synthesis.tts_batch` returned for a nyanko model,
with the plain reference of nyanko.py: the numbers and the method of
synthesis.py's `judge_call` (its builder-free helpers are imported from
there and from dsp.py).

For each sampled call the reference works out again, from the texts and
the seeded weights alone: the text ids and their padded batch; the text
encoder; the decoder one step at a time, teacher-forced on the frames the
program emitted (step t reads the program's frame t - 1 and predicts frame
t, so the gap stays at one step's error however long the decode), its
monotonic window at the reference's own most probable key, except where
the two best keys lie within `TIE` of each other: the program may have
latched either, and the reference takes the one whose next frame lies
nearer the program's; the converter on the reference's decoder states;
Griffin-Lim on the magnitudes of the program's linear spectrogram, judged
by spectral convergence against the reference's own bf16 schedule.

`control` puts the reference one precision lower in the program's place
(TF32 for the f32 model, e4m3 for the bf16 Griffin-Lim)."""

import torch

from . import dsp
from . import nyanko as nk
from .synthesis import (TIE, _norm, precision, program_arrays,  # noqa: F401
                        shape_faults, text_batch, worst)


def _pick(use, a, b):
    """Rows `use` of tree b, the others of tree a."""
    if isinstance(a, dict):
        return {k: _pick(use, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_pick(use, u, v) for u, v in zip(a, b))
    return torch.where(use.reshape((-1,) + (1,) * (a.dim() - 1)), b, a)


def teacher_forced(tree, cfg, x, pos, lengths, frames):
    """The decoder over the program's frames (B, N, F), step t fed the
    program's frame t - 1 (zeros at t = 0). Returns (predicted frames
    (B, N, F), probabilities (B, N, Tk), decoder states (B, N, D), rows
    whose window followed the program's side of a tie)."""
    keys, values = nk.encoder(tree, cfg, x)
    keys = nk.keys_with_positions(tree, keys, pos)
    mask = nk.padding_mask(lengths, x.shape[1])
    B, N, _ = frames.shape
    state = nk.init_state(cfg, B, x.device)
    la_alt = state["last_attended"]
    x_t = torch.zeros_like(frames[:, 0])
    outs, probs_t, states, followed = [], [], [], 0
    mono = cfg.decoder.force_monotonic_attention
    for t in range(N):
        new = nk.decoder_step(tree, cfg, keys, values, mask, state, x_t)
        rows = la_alt != state["last_attended"]
        if mono and bool(rows.any()):
            alt = nk.decoder_step(tree, cfg, keys, values, mask, state, x_t,
                                  last_attended=la_alt)
            d_new = (new[1] - frames[:, t]).abs().amax(dim=1)
            d_alt = (alt[1] - frames[:, t]).abs().amax(dim=1)
            use = rows & (d_alt < d_new)
            followed += int(use.sum())
            new = _pick(use, new, alt)
        state, y, probs, _, h = new
        outs.append(y)
        probs_t.append(probs)
        states.append(h)
        if mono:
            top = torch.topk(probs, min(2, probs.shape[1]), dim=-1)
            near = top.values[:, 0] - top.values[:, -1] < TIE
            la_alt = torch.where(near, top.indices[:, -1], top.indices[:, 0])
        x_t = frames[:, t]
    return (torch.stack(outs, 1), torch.stack(probs_t, 1),
            torch.stack(states, 1), followed)


def converter(tree, cfg, states):
    """Decoder states (B, N, D) -> normalised linear (B, 4N, Fd)."""
    return nk.converter(tree, cfg, states)


def judge_call(tree, cfg, hp, texts, speaker_ids, n_steps, results, device,
               model_precision="f32", gl_carry="bf16"):
    """The numbers compared for one tts_batch call of a nyanko model, as
    synthesis.judge_call reads them for DeepVoice3. speaker_ids: None (a
    single-speaker model)."""
    if speaker_ids is not None:
        raise ValueError("nyanko is single-speaker")
    if not cfg.use_decoder_state_for_postnet_input:
        raise ValueError("the judge feeds the converter decoder states")
    up = cfg.converter.time_upsampling
    faults = shape_faults(results, texts, n_steps, hp, up)
    if faults:
        return {"shape_faults": faults}
    mel_db, lin_db, al, wav = program_arrays(results, device)
    x, pos, lengths = text_batch(texts, device)
    frames = _norm(mel_db, hp).reshape(mel_db.shape[0], n_steps, -1)
    with torch.no_grad(), precision("f32"):
        ref = teacher_forced(tree, cfg, x, pos, lengths, frames)
        ref_lin = converter(tree, cfg, ref[2])
    out = {"shape_faults": 0}
    if model_precision == "f32":
        cand_frames, cand_al, cand_lin = frames, al, _norm(lin_db, hp)
        followed = ref[3]
    else:
        with torch.no_grad(), precision(model_precision):
            low = teacher_forced(tree, cfg, x, pos, lengths, frames)
            cand_lin = converter(tree, cfg, low[2])
        cand_frames, cand_al, followed = low[0], low[1], low[3]
    tk = al.shape[2]
    out["frame_gap"] = float((cand_frames - ref[0]).abs().max())
    out["align_gap"] = float((cand_al[..., :tk] - ref[1][..., :tk])
                             .abs().max())
    out["linear_gap"] = float((cand_lin - ref_lin).abs().max())
    out["windows_followed"] = followed
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
    """The reference one precision below the configuration's in the
    program's place, read against the reference."""
    return judge_call(tree, cfg, hp, texts, speaker_ids, n_steps, results,
                      device, model_precision="tf32", gl_carry="fp8")
