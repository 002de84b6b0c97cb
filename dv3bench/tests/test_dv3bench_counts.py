# coding: utf-8
"""The analytic operation counts against torch's FlopCounterMode on the
plain reference at tiny widths."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_hp
from dv3bench import counts
from dv3bench.kernels import b1, b2, b3
from dv3bench.reference import builder, dsp, params, synthesis
from dv3bench.reference import deepvoice3 as dv3
from dv3bench.reference import text


def _cfg(config):
    hp = tiny_hp(config)
    return hp, builder.config_from_hparams(hp, text.N_VOCAB)


def _forward(tree, cfg, B, Tk, T_dec, spk):
    g = torch.Generator().manual_seed(0)
    x = torch.randint(2, 60, (B, Tk), generator=g)
    pos = torch.arange(1, Tk + 1).repeat(B, 1)
    mel = torch.rand(B, T_dec, cfg.mel_dim * cfg.r, generator=g)
    se = None if spk is None else tree["embed_speakers"]["w"][spk]
    enc = dv3.encoder_apply(tree["encoder"], cfg.encoder, x, speaker_embed=se)
    _, _, _, states = dv3.decoder_apply(
        tree["decoder"], cfg.decoder, enc, mel, text_positions=pos,
        frame_positions=torch.arange(1, T_dec + 1).repeat(B, 1),
        speaker_embed=se)
    dv3.converter_apply(tree["converter"], cfg.converter,
                        states.reshape(B, T_dec * cfg.r, -1),
                        speaker_embed=se)


def test_forward_flops_match_flop_counter():
    for config in ("dv3_ljspeech", "dv3_vctk"):
        hp, cfg = _cfg(config)
        tree = params.seeded_tree(cfg, 3, "cpu")
        B, Tk, T_dec = 2, 24, 12
        spk = torch.tensor([1, 5]) if cfg.n_speakers > 1 else None
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            _forward(tree, cfg, B, Tk, T_dec, spk)
        assert counts.forward_flops(cfg, B, Tk, T_dec) == fc.get_total_flops()


def test_kw_convs_are_every_convolution():
    hp, cfg = _cfg("dv3_vctk")
    tree = params.seeded_tree(cfg, 3, "cpu")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        _forward(tree, cfg, 2, 24, 12, torch.tensor([1, 5]))
    conv = fc.get_flop_counts()["Global"][torch.ops.aten.convolution]
    assert conv == sum(2 * rows * kw * cin * cout for rows, cin, cout, kw
                       in b3.kw_convs(cfg, 2, 24, 12))


def test_train_step_flops_bound_the_counted_backward():
    """Forward and backward counted by FlopCounterMode against 3x the
    forward: the analytic count may only exceed it by the input gradients
    of layers whose input carries none (the decoder's first layer)."""
    hp, cfg = _cfg("dv3_ljspeech")
    tree = params.seeded_tree(cfg, 3, "cpu")
    flat = params.flatten(tree)
    for k, v in flat.items():
        v.requires_grad_(True)
    B, Tk, T_dec = 2, 24, 12
    with FlopCounterMode(display=False) as fc:
        g = torch.Generator().manual_seed(0)
        x = torch.randint(2, 60, (B, Tk), generator=g)
        enc = dv3.encoder_apply(tree["encoder"], cfg.encoder, x)
        out = dv3.decoder_apply(
            tree["decoder"], cfg.decoder, enc,
            torch.rand(B, T_dec, cfg.mel_dim, generator=g),
            text_positions=torch.arange(1, Tk + 1).repeat(B, 1),
            frame_positions=torch.arange(1, T_dec + 1).repeat(B, 1))
        lin = dv3.converter_apply(tree["converter"], cfg.converter,
                                  out[3].reshape(B, T_dec, -1))
        (out[0].sum() + lin.sum()).backward()
    counted = fc.get_total_flops()
    analytic = 3 * counts.forward_flops(cfg, B, Tk, T_dec)
    assert counted <= analytic <= 1.05 * counted


def test_b1_weight_macs_match_one_step():
    """One reference decode step's products, less the attention's scores
    and context over every key, are one MAC per weight B1 counts, but for
    the done projection, which the reference's step leaves out."""
    hp, cfg = _cfg("dv3_ljspeech")
    tree = params.seeded_tree(cfg, 3, "cpu")
    B, Tk = 3, 16
    x = torch.randint(2, 60, (B, Tk))
    pos = torch.arange(1, Tk + 1).repeat(B, 1)
    dc = cfg.decoder
    kv, wq = dv3.decoder_precompute(tree["decoder"], dc, dv3.encoder_apply(
        tree["encoder"], cfg.encoder, x), text_positions=pos)
    state = dv3.decoder_init_state(dc, B)
    la = state.pop("last_attended")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        synthesis._step(tree["decoder"], dc, kv, wq, None, None, state,
                        torch.zeros(B, dc.in_dim * dc.r), la)
    E = dc.embed_dim
    scores = 2 * 2 * B * Tk * E * dc.num_attention_layers
    done = dc.in_dim * dc.r
    assert fc.get_total_flops() - scores == 2 * B * (
        b1.decode_weight_macs(cfg) - done)


def test_b2_work_matches_flop_counter():
    hp, _ = _cfg("dv3_ljspeech")
    hp.update(griffin_lim_iters=3)
    S = torch.rand(2, 10, hp["fft_size"] // 2 + 1)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        dsp.griffin_lim_run(S, hp)
    assert b2.work(hp, 2, 10)[0] == fc.get_total_flops()
