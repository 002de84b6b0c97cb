# coding: utf-8
"""The port's CUDA kernels against their plain versions on the card, at
small shapes that reach the cases chip_smoke.py does not: chunk hand-off
of the decode carry across launches, non-monotonic attention, no mask,
long padded texts, the nyanko and multi-speaker decoders (highway,
save_q / linear2, speaker biases, finished position encodings), ring
buffers placed in device memory under a small shared-memory budget and at
the nyanko preset's width, tile edges of the Griffin-Lim GEMMs, its streaming
modes (given start, pinned frames, returned spectrum) and unfolded
windows, Griffin-Lim at every framing with hop | fft (k = 8 and 16, hops
off 4, ffts off 8 and 64) and a narrow model's tts_batch at hop 128, a
tiny model's stream on the card against the CPU, B1's serving
modes (per-row positions and context scales, a text-bucket growth between
launches, a ring placement that changes with the bucket), a tiny model's
continuous batcher on the card against the CPU, and the ragged
edges of the tap-accumulating conv (T, C, N off the tiles, B = 1, taps
wholly in the pad) on the route each shape takes (counted per route), the
bf16 forward and input gradient at both tile widths, and the determinism
of its weight gradient.

Marked `cuda`: each test skips when no CUDA device is present. On a machine
with a card (the JAX package need not be installed):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from deepvoice3_pytorch_tpu_torch import builder
from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp
from deepvoice3_pytorch_tpu_torch.models import deepvoice3 as dv3
from deepvoice3_pytorch_tpu_torch.ops import core
from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with core.strict_numerics():
        yield torch.device("cuda", 0)


def _decoder(dev, width=32, monotonic=True, Tk=12, B=3, seed=0):
    cfg = builder.deepvoice3(
        n_vocab=149, embed_dim=width, mel_dim=16, linear_dim=65, r=1,
        downsample_step=4, kernel_size=3, encoder_channels=width,
        decoder_channels=width, converter_channels=width,
        use_memory_mask=True, key_projection=True, value_projection=True,
        max_positions=max(64, Tk + 1), force_monotonic_attention=monotonic)
    params = builder.model_init(cfg, torch.Generator().manual_seed(seed), dev)
    g = torch.Generator().manual_seed(seed + 1)
    enc = tuple(torch.randn(B, Tk, width, generator=g).to(dev) * 0.5
                for _ in range(2))
    lengths = torch.randint(Tk // 2, Tk + 1, (B,), generator=g).to(dev)
    pos = torch.arange(1, Tk + 1, device=dev)[None].repeat(B, 1)
    pos = torch.where(pos <= lengths[:, None], pos, torch.zeros_like(pos))
    return cfg, params["decoder"], enc, pos, lengths


def _close(got, want, tol):
    """Within tol of each output's scale (max(1, max|want|)), last_attended
    and step counts exact."""
    for name in ("outputs", "alignments", "done", "decoder_states"):
        a, b = getattr(got, name), getattr(want, name)
        d = float((a - b).abs().max())
        assert d <= tol * max(1.0, float(b.abs().max())), (name, d)
    assert torch.equal(got.last_attended, want.last_attended)
    assert got.num_steps == want.num_steps


@pytest.mark.parametrize("name,T,chunk,monotonic,masked,early_exit", [
    ("deepvoice3", 11, 32, True, True, False),
    ("deepvoice3", 11, 3, True, True, False),
    ("deepvoice3", 11, 4, False, True, False),
    ("deepvoice3", 11, 5, True, False, False),
    ("deepvoice3", 11, 4, True, True, True),
    # a last launch of T - t0 < chunk steps
    ("deepvoice3", 45, 32, True, True, False),
    ("deepvoice3", 45, 32, True, True, True),
    ("nyanko", 45, 32, True, True, False),
    ("nyanko", 45, 32, True, True, True),
    ("deepvoice3_multispeaker", 45, 32, True, True, False),
    ("deepvoice3_multispeaker", 45, 32, True, True, True)])
def test_fused_decode_kernel_matches_plain(dev, name, T, chunk, monotonic,
                                           masked, early_exit):
    if name == "deepvoice3":
        cfg, pd, enc, pos, lengths = _decoder(dev, monotonic=monotonic)
        fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    else:
        cfg, pd, fi, lengths = _family_decoder(dev, name)
    mask = core.get_mask_from_lengths(lengths, 12) if masked else None
    init = torch.zeros(3, 16, device=dev)
    args = (pd, cfg.decoder, fi, mask, init, T, 2)
    fd.KERNEL.launches = 0
    got = fd.fused_decode(*args, early_exit=early_exit, chunk=chunk)
    assert fd.KERNEL.launches == -(-got.num_steps // min(chunk, T))
    want = fd.fused_decode_plain(*args, early_exit=early_exit, chunk=chunk)
    _close(got, want, 1e-4)
    assert got.outputs.shape[1] == T


@pytest.mark.parametrize("name", ["deepvoice3", "nyanko",
                                  "deepvoice3_multispeaker"])
def test_short_last_launch_is_bit_equal_to_a_whole_chunk(dev, name):
    """A decode of N = 70 frames (launches of 32, 32 and 6 steps) gives
    frames, alignments, done and decoder states bit-equal to frames 0..69
    of a decode of 96 (three whole chunks), and last_attended equal to
    that decode's carry after frame 70 (its third chunk launched as 6
    steps, then 26, which gives its frames bit for bit too)."""
    if name == "deepvoice3":
        cfg, pd, enc, pos, lengths = _decoder(dev)
        fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    else:
        cfg, pd, fi, lengths = _family_decoder(dev, name)
    mask = core.get_mask_from_lengths(lengths, 12)
    init = torch.zeros(3, 16, device=dev)
    fd.KERNEL.launches = 0
    short = fd.fused_decode(pd, cfg.decoder, fi, mask, init, 70, 2,
                            early_exit=False, chunk=32)
    assert fd.KERNEL.launches == 3 and short.num_steps == 70
    whole = fd.fused_decode(pd, cfg.decoder, fi, mask, init, 96, 2,
                            early_exit=False, chunk=32)
    dec = fd.FusedDecoder(pd, cfg.decoder, fi, mask, 96)
    carry = dec.zero_carry(init)
    outs = dec.new_outputs(96)
    for t0, steps in ((0, 32), (32, 32), (64, 6)):
        dec.launch(carry, outs, t0, steps)
    after_70 = dec.last_attended(carry).clone()
    dec.launch(carry, outs, 70, 26)
    names = ("outputs", "alignments", "done", "decoder_states")
    for i, n in enumerate(names):
        assert torch.equal(outs[i], getattr(whole, n)), n
        assert torch.equal(getattr(short, n), getattr(whole, n)[:, :70]), n
    assert torch.equal(dec.last_attended(carry), whole.last_attended)
    assert torch.equal(short.last_attended, after_70)


def test_fused_decode_kernel_long_text(dev):
    """Tk = 500 padded positions (more than one score per thread) at width
    64."""
    cfg, pd, enc, pos, lengths = _decoder(dev, width=64, Tk=500, B=2)
    fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    mask = core.get_mask_from_lengths(lengths, 500)
    args = (pd, cfg.decoder, fi, mask, torch.zeros(2, 16, device=dev), 9, 2)
    _close(fd.fused_decode(*args, early_exit=False),
           fd.fused_decode_plain(*args, early_exit=False), 1e-4)


def _family_decoder(dev, name, width=32, B=3, Tk=12, seed=0, speakers=True):
    """A tiny nyanko or multi-speaker decoder with random encoder outputs;
    (cfg, decoder params, fused_decode_inputs, lengths)."""
    kw = dict(n_vocab=149, embed_dim=width, mel_dim=16, linear_dim=65, r=1,
              downsample_step=4, kernel_size=3, encoder_channels=width,
              decoder_channels=width, converter_channels=width,
              use_memory_mask=True, max_positions=64,
              force_monotonic_attention=True)
    if name == "deepvoice3_multispeaker":
        kw.update(n_speakers=5, speaker_embed_dim=8, key_projection=True,
                  value_projection=True, query_position_rate=2.0,
                  key_position_rate=7.6)
    cfg = getattr(builder, name)(**kw)
    params = builder.model_init(cfg, torch.Generator().manual_seed(seed), dev)
    g = torch.Generator().manual_seed(seed + 1)
    enc = tuple(torch.randn(B, Tk, width, generator=g).to(dev) * 0.5
                for _ in range(2))
    lengths = torch.randint(Tk // 2, Tk + 1, (B,), generator=g).to(dev)
    pos = torch.arange(1, Tk + 1, device=dev)[None].repeat(B, 1)
    pos = torch.where(pos <= lengths[:, None], pos, torch.zeros_like(pos))
    se = None
    if cfg.n_speakers > 1 and speakers:
        ids = torch.arange(B, device=dev) % cfg.n_speakers
        se = builder.embed_speakers(params, cfg, ids)
    fi = cfg.family.fused_decode_inputs(params["decoder"], cfg.decoder, enc,
                                        pos, speaker_embed=se)
    return cfg, params["decoder"], fi, lengths


@pytest.mark.parametrize("name,chunk,masked,speakers", [
    ("nyanko", 32, True, True), ("nyanko", 3, True, True),
    ("nyanko", 4, False, True),
    ("deepvoice3_multispeaker", 32, True, True),
    ("deepvoice3_multispeaker", 3, True, True),
    ("deepvoice3_multispeaker", 4, True, False)])
def test_fused_decode_families_match_plain(dev, name, chunk, masked,
                                           speakers):
    """nyanko (highway, save_q, linear2, finished position encodings) and
    the multi-speaker decoder (speaker biases, per-sample query rates; and
    without a speaker, zero biases as the plain step adds none), with the
    carry handed across chunks of 3 and 4."""
    cfg, pd, fi, lengths = _family_decoder(dev, name, speakers=speakers)
    mask = core.get_mask_from_lengths(lengths, 12) if masked else None
    args = (pd, cfg.decoder, fi, mask, torch.zeros(3, 16, device=dev), 11, 2)
    fd.KERNEL.launches = 0
    got = fd.fused_decode(*args, early_exit=False, chunk=chunk)
    assert fd.KERNEL.launches == -(-11 // min(chunk, 11))
    _close(got, fd.fused_decode_plain(*args, early_exit=False, chunk=chunk),
           1e-4)


@pytest.mark.parametrize("name", ["nyanko", "deepvoice3_multispeaker"])
def test_fused_decode_ring_placement_in_device_memory(dev, name):
    """The ring buffers live in device memory, and the weights' placement
    follows the shared-memory budget: every slice in shared memory, about
    half of them, and none give the very same frames and carry, over a
    carry hand-off; a budget below the kernel's fixed part raises."""
    cfg, pd, fi, lengths = _family_decoder(dev, name)
    mask = core.get_mask_from_lengths(lengths, 12)
    init = torch.zeros(3, 16, device=dev)
    full = fd.FusedDecoder(pd, cfg.decoder, fi, mask, 10)
    lay = full.layout
    assert lay.resident == lay.per_block and full.scratch.shape == (
        3, full.scratch_floats)
    assert full.scratch_floats == full.ring_floats + sum(
        c for _, c, _ in full.plan.buffers)     # a slot more a buffer
    fixed = 4 * fd.b1_smem_floats(lay.meta, 0, lay.max_ncp)
    runs = []
    for budget in (None, fixed + 2 * lay.per_block, fixed):
        dec = full if budget is None else fd.FusedDecoder(
            pd, cfg.decoder, fi, mask, 10, smem_budget=budget)
        if budget == fixed:
            assert dec.layout.resident == 0
        elif budget is not None:
            assert 0 < dec.layout.resident < dec.layout.per_block
        carry, outs = dec.zero_carry(init), dec.new_outputs(10)
        dec.launch(carry, outs, 0, 6)
        dec.launch(carry, outs, 6, 4)
        runs.append(outs + tuple(carry))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        fd.FusedDecoder(pd, cfg.decoder, fi, mask, 10,
                        smem_budget=fixed - 4)


@pytest.mark.parametrize("preset,off_chip", [
    ("nyanko_ljspeech", True), ("deepvoice3_vctk", False),
    ("deepvoice3_ljspeech", False)])
def test_fused_decode_preset_widths(dev, preset, off_chip):
    """Each preset's decoder at full width, B = 2, Tk = 40, 12 steps,
    kernel against plain: every preset's weights stay in shared memory on
    a grid of one block an SM; nyanko's also on a grid of 114 blocks, where
    its 27.7 MB of folded weights leave shared memory in part (the rest is
    read from device memory each step). Bar: 3x the plain f32 decode's own
    drift from a float64 one (chip_smoke.py's B1 bar), last_attended
    exact."""
    import copy
    import json
    import os

    from deepvoice3_pytorch_tpu_torch import hparams, model_builder

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hp = hparams.default_hparams()
    with open(os.path.join(repo, "presets", preset + ".json")) as f:
        hp.parse_json(f.read())
    cfg, params = model_builder.build_model(hp, 149, seed=3, device=dev)
    B, Tk = 2, 40
    g = torch.Generator().manual_seed(4)
    width = (cfg.decoder.channels if cfg.builder == "nyanko"
             else cfg.decoder.embed_dim)
    enc = tuple(torch.randn(B, Tk, width, generator=g).to(dev) * 0.5
                for _ in range(2))
    pos = torch.arange(1, Tk + 1, device=dev)[None].repeat(B, 1)
    se = (builder.embed_speakers(params, cfg, torch.tensor([7, 14],
                                                           device=dev))
          if cfg.n_speakers > 1 else None)
    pd = params["decoder"]
    fam = cfg.family
    fi = fam.fused_decode_inputs(pd, cfg.decoder, enc, pos, 12,
                                 speaker_embed=se)
    dec = fd.FusedDecoder(pd, cfg.decoder, fi, None, 12,
                          grid=114 if off_chip else None)
    lay = dec.layout
    assert (lay.resident < lay.per_block) == off_chip, json.dumps(
        [lay.grid, lay.resident, lay.per_block])
    init = torch.zeros(B, dec.out_dim, device=dev)
    carry, outs = dec.zero_carry(init), dec.new_outputs(12)
    dec.launch(carry, outs, 0, 12)
    got = fd.FusedDecodeOut(*outs, 12, dec.last_attended(carry))
    want = fd.fused_decode_plain(pd, cfg.decoder, fi, None, init, 12, 2,
                                 early_exit=False)
    pd64 = copy.deepcopy(pd).double()
    se64 = None if se is None else se.double()
    fi64 = fam.fused_decode_inputs(pd64, cfg.decoder,
                                   tuple(e.double() for e in enc), pos, 12,
                                   speaker_embed=se64)
    exact = fd.fused_decode_plain(pd64, cfg.decoder, fi64, None,
                                  init.double(), 12, 2, early_exit=False)
    for name in ("outputs", "alignments", "done", "decoder_states"):
        err = float((getattr(got, name) - getattr(want, name)).abs().max())
        floor = float((getattr(want, name).double()
                       - getattr(exact, name)).abs().max())
        assert err <= 3 * floor + 1e-6, (name, err, floor)
    assert torch.equal(got.last_attended, want.last_attended)


def _preset_decoder(dev, preset, B, Tk, steps, seed=3):
    """A preset's decoder at full width (seeded weights) over random
    encoder outputs of B rows (lengths Tk // 2 .. Tk; speakers 7 b mod n
    for a multi-speaker preset), with the same in float64: a dict of cfg,
    pd, fi, lengths, mask, se and pd64, fi64, se64, enc (the float32
    encoder outputs)."""
    import copy
    import os

    from deepvoice3_pytorch_tpu_torch import hparams, model_builder

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hp = hparams.default_hparams()
    with open(os.path.join(repo, "presets", preset + ".json")) as f:
        hp.parse_json(f.read())
    cfg, params = model_builder.build_model(hp, 149, seed=seed, device=dev)
    g = torch.Generator().manual_seed(seed + 1)
    width = (cfg.decoder.channels if cfg.builder == "nyanko"
             else cfg.decoder.embed_dim)
    enc = tuple(torch.randn(B, Tk, width, generator=g).to(dev) * 0.5
                for _ in range(2))
    lengths = torch.randint(Tk // 2, Tk + 1, (B,), generator=g).to(dev)
    pos = torch.arange(1, Tk + 1, device=dev)[None].repeat(B, 1)
    pos = torch.where(pos <= lengths[:, None], pos, torch.zeros_like(pos))
    se = (builder.embed_speakers(params, cfg, (7 * torch.arange(
        B, device=dev)) % cfg.n_speakers) if cfg.n_speakers > 1 else None)
    pd, fam = params["decoder"], cfg.family
    pd64 = copy.deepcopy(pd).double()
    se64 = None if se is None else se.double()
    return dict(
        cfg=cfg, pd=pd, pd64=pd64, lengths=lengths, se=se, se64=se64,
        enc=enc, mask=core.get_mask_from_lengths(lengths, Tk),
        fi=fam.fused_decode_inputs(pd, cfg.decoder, enc, pos, steps,
                                   speaker_embed=se),
        fi64=fam.fused_decode_inputs(pd64, cfg.decoder,
                                     tuple(e.double() for e in enc), pos,
                                     steps, speaker_embed=se64))


def _within_drift(got, want, exact, names):
    """Each of got's outputs within 3x the plain f32 decode's own drift
    from a float64 one, + 1e-6 (B1's bar)."""
    for name, a, b, e in zip(names, got, want, exact):
        err = float((a - b).abs().max())
        floor = float((b.double() - e).abs().max())
        assert err <= 3 * floor + 1e-6, (name, err, floor)


@pytest.mark.parametrize("route", ["chunk", "serving", "teacher"])
@pytest.mark.parametrize("preset", ["deepvoice3_ljspeech", "deepvoice3_vctk",
                                    "nyanko_ljspeech"])
def test_b1_routes_at_preset_widths(dev, preset, route):
    """B1 against its plain version at each preset's full width (VCTK with
    its speakers' softsign biases) on its three routes: chunk mode at B =
    32 over 64 steps in two launches (more steps than the 55 slots of the
    longest ring), serving mode at S = 8 slots at their own positions over
    two launches of 32 steps, and the teacher-forced route (a frame a
    launch, 12 frames at B = 8). Bar: 3x the plain f32 decode's drift from
    a float64 one + 1e-6, last_attended exact. In chunk mode, each stage
    kind's products and epilogue, from the launches' stamps, sum to its
    work."""
    from deepvoice3_pytorch_tpu_torch.utils import profiling

    names = ("outputs", "alignments", "done", "decoder_states")
    B, Tk, steps = {"chunk": (32, 96, 64), "serving": (8, 96, 32),
                    "teacher": (8, 40, 12)}[route]
    x = _preset_decoder(dev, preset, B, Tk, 2 * steps)
    cfg, pd, dc = x["cfg"], x["pd"], x["cfg"].decoder
    out_dim = dc.in_dim * dc.r
    if route == "chunk":
        init = torch.zeros(B, out_dim, device=dev)
        args = (x["mask"], init, steps, 2)
        with profiling.recording() as w:
            got = fd.fused_decode(pd, dc, x["fi"], *args, early_exit=False,
                                  chunk=32)
        want = fd.fused_decode_plain(pd, dc, x["fi"], *args,
                                     early_exit=False, chunk=32)
        exact = fd.fused_decode_plain(
            x["pd64"], dc, x["fi64"], x["mask"], init.double(), steps, 2,
            early_exit=False, chunk=32)
        _within_drift(got[:4], want[:4], exact[:4], names)
        assert torch.equal(got.last_attended, want.last_attended)
        split = w.b1_split()
        assert split["launches"] == 2
        for part in split["kinds"].values():
            assert part["products_ns"] + part["epilogue_ns"] == \
                part["work_ns"]
        convs = "HIGHWAY" if cfg.builder == "nyanko" else "GLU"
        assert split["kinds"][convs]["products_ns"] > 0
    elif route == "serving":
        kern = fd.SlotDecoder(pd, dc, B, dev)
        scales = [n * (1.0 / n) ** 0.5 for n in [64] * (B // 2)
                  + [Tk] * (B - B // 2)]
        si = _slot_inputs(x["fi"], x["lengths"], Tk, scales, kern.att_w)
        si64 = _slot_inputs(x["fi64"], x["lengths"], Tk, scales, None)
        plain = fd.PlainSlotDecoder(pd, dc, B, dev)
        plain64 = fd.PlainSlotDecoder(x["pd64"], dc, B, dev,
                                      dtype=torch.float64)
        local = torch.arange(B, device=dev) * 16

        def run(dec, inputs):
            carry = dec.zero_carry()
            dec.positions(carry)[:] = local
            outs = []
            for _ in range(2):
                o = dec.new_outputs(steps, Tk)
                dec.launch(inputs, carry, o, steps)
                outs.append(o)
            return [torch.cat(o, dim=1) for o in zip(*outs)], carry

        got, c_k = run(kern, si)
        want, c_p = run(plain, si)
        exact, _ = run(plain64, si64)
        _within_drift(got, want, exact, names)
        la_p = c_p["state"]["last_attended"][:, plain.att].to(torch.int32)
        assert torch.equal(c_k.last_attended[:, :len(plain.att)], la_p)
        assert torch.equal(c_k.pos.long(), local + 2 * steps)
    else:
        frames = torch.rand(B, steps, out_dim,
                            generator=torch.Generator().manual_seed(5)) \
            .to(dev)
        args = (x["mask"], None, steps, dc.min_decoder_steps)
        fd.KERNEL.reset_counts()
        got = fd.fused_decode(pd, dc, x["fi"], *args, test_inputs=frames)
        assert fd.KERNEL.by_entry == {"chunk": steps}
        want = fd.fused_decode_plain(pd, dc, x["fi"], *args,
                                     test_inputs=frames)
        exact = fd.fused_decode_plain(x["pd64"], dc, x["fi64"], *args,
                                      test_inputs=frames.double())
        _within_drift(got[:4], want[:4], exact[:4], names)
        assert torch.equal(got.last_attended, want.last_attended)


def test_fused_decode_carry_resumes(dev):
    """Two launches through the public FusedDecoder interface equal one."""
    cfg, pd, enc, pos, lengths = _decoder(dev)
    fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    mask = core.get_mask_from_lengths(lengths, 12)
    dec = fd.FusedDecoder(pd, cfg.decoder, fi, mask, 10)
    init = torch.zeros(3, 16, device=dev)
    c1, o1 = dec.zero_carry(init), dec.new_outputs(10)
    dec.launch(c1, o1, 0, 10)
    c2, o2 = dec.zero_carry(init), dec.new_outputs(10)
    dec.launch(c2, o2, 0, 6)
    dec.launch(c2, o2, 6, 4)
    for a, b in zip(o1 + tuple(c1), o2 + tuple(c2)):
        assert torch.equal(a, b)


def _slot_inputs(fi, lengths, Tk, scales, att_w):
    """SlotInputs with row b = row b of the batched inputs fi, folded with
    a kernel decoder's att_w."""
    mask = core.get_mask_from_lengths(lengths, Tk)
    B = mask.shape[0]

    def row(b):
        one = slice(b, b + 1)
        return dict(fi, projected_kv=[
            None if p is None else (p[0][one], p[1][one])
            for p in fi["projected_kv"]],
            w_query=None if fi["w_query"] is None else fi["w_query"][one],
            speaker_bias=[x[one] for x in fi["speaker_bias"] or []],
            speaker_embed=(None if fi.get("speaker_embed") is None
                           else fi["speaker_embed"][one]))

    si = fd.slot_inputs(row(0), B, Tk, att_w)
    for b in range(B):
        fd.write_slot_row(si, b, row(b), mask[b:b + 1], scales[b])
    return si


def _slot_pair(dev, name, B=4, Tk=12, kern_kw=None):
    """Kernel and plain slot decoders over one family's tiny decoder, slot
    inputs at their own scales, both carries at positions (0, 5, 30, 60):
    the last row runs past the 64-row table within a launch. kern_kw: more
    arguments of the kernel's SlotDecoder."""
    if name == "deepvoice3":
        cfg, pd, enc, pos, lengths = _decoder(dev, B=B, Tk=Tk)
        fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    else:
        cfg, pd, fi, lengths = _family_decoder(dev, name, B=B, Tk=Tk)
    kern = fd.SlotDecoder(pd, cfg.decoder, B, dev, **(kern_kw or {}))
    si = _slot_inputs(fi, lengths, Tk,
                      [n * (1.0 / n) ** 0.5 for n in (8, 12, 16, 64)],
                      kern.att_w)
    plain = fd.PlainSlotDecoder(pd, cfg.decoder, B, dev)
    carries = [kern.zero_carry(), plain.zero_carry()]
    local = torch.tensor([0, 5, 30, 60], device=dev)
    for d, c in zip((kern, plain), carries):
        d.positions(c)[:] = local
    return kern, plain, carries, si, local


def _slot_launch(kern, plain, carries, si, steps, tol=1e-4):
    """One launch of both; outputs within tol of each output's scale,
    last_attended and positions exact."""
    outs = []
    for d, c in zip((kern, plain), carries):
        o = d.new_outputs(steps, si.addmask.shape[1])
        d.launch(si, c, o, steps)
        outs.append(o)
    for name, a, b in zip(("outputs", "alignments", "done", "states"),
                          *outs):
        err = float((a - b).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max())), (name, err)
    k, p = carries
    la_p = p["state"]["last_attended"][:, plain.att].to(torch.int32)
    assert torch.equal(k.last_attended[:, :len(plain.att)], la_p)
    assert torch.equal(k.pos.long(), p["state"]["pos"])


@pytest.mark.parametrize("name", ["deepvoice3", "nyanko",
                                  "deepvoice3_multispeaker"])
def test_slot_decoder_kernel_matches_plain(dev, name):
    """B1's serving modes (per-row positions advanced in the kernel,
    per-row context scales) against the plain per-row decode, over two
    launches with a text-bucket growth between them: the carry is kept,
    the grown keys are masked, each row keeps its scale."""
    kern, plain, carries, si, local = _slot_pair(dev, name)
    fd.KERNEL.reset_counts()
    _slot_launch(kern, plain, carries, si, 5)
    si = fd.grow_slot_inputs(si, 20)
    _slot_launch(kern, plain, carries, si, 6)
    assert kern.tk == 20 and fd.KERNEL.by_entry == {"slots": 2}
    assert carries[0].pos.tolist() == (local + 11).tolist()
    with pytest.raises(ValueError):
        fd.grow_slot_inputs(si, 20)


def test_slot_decoder_refuses_inputs_folded_for_other_weights(dev):
    """The kernel reads the K/V folded at admission: inputs kept for the
    plain decoder (no fold) or folded by another decoder are refused."""
    kern, _, carries, si, _ = _slot_pair(dev, "deepvoice3")
    outs = kern.new_outputs(2, si.addmask.shape[1])
    cfg1, pd1 = _decoder(dev, B=4, Tk=12, seed=1)[:2]
    other = fd.SlotDecoder(pd1, cfg1.decoder, 4, dev)
    for bad in (si._replace(att_w=None, kvf=None),
                si._replace(att_w=other.att_w)):
        with pytest.raises(ValueError):
            kern.launch(bad, carries[0], outs, 2)
    kern.launch(si, carries[0], outs, 2)


@pytest.mark.parametrize("name", ["nyanko", "deepvoice3_multispeaker"])
def test_slot_decoder_ring_placement_follows_the_bucket(dev, name):
    """A slot decoder on a grid of 8 blocks whose shared-memory budget
    keeps part of the weights: across a text-bucket growth (the attention
    scratch follows the new Tk) the frames still equal the plain
    decode's."""
    cfg, pd = _family_decoder(dev, name, B=4)[:2]
    lay = fd.SlotDecoder(pd, cfg.decoder, 4, dev, grid=8).layout
    budget = 4 * (fd.b1_smem_floats(lay.meta, 0, lay.max_ncp)
                  + lay.per_block // 2)
    small, plain, carries, si, _ = _slot_pair(
        dev, name, kern_kw=dict(grid=8, smem_budget=budget))
    lay = small.layout
    assert lay.grid == 8 and 0 < lay.resident < lay.per_block
    _slot_launch(small, plain, carries, si, 4)
    si = fd.grow_slot_inputs(si, 44)
    _slot_launch(small, plain, carries, si, 4)
    assert small.tk == 44 and small.att.shape[2] == 44


@pytest.mark.parametrize("B", [1, 8, 32, 33])
def test_fused_decode_batch_sizes(dev, B):
    """B = 1, 8, 32 and 33 rows (33: a row pair split, and a second pass
    over the rows of a stage), width 64, kernel against plain; two runs
    bit-equal."""
    cfg, pd, enc, pos, lengths = _decoder(dev, width=64, B=B, Tk=24)
    fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    mask = core.get_mask_from_lengths(lengths, 24)
    args = (pd, cfg.decoder, fi, mask, torch.zeros(B, 16, device=dev), 14,
            2)
    got = fd.fused_decode(*args, early_exit=False, chunk=8)
    again = fd.fused_decode(*args, early_exit=False, chunk=8)
    _close(got, fd.fused_decode_plain(*args, early_exit=False, chunk=8),
           1e-4)
    for name in ("outputs", "alignments", "done", "decoder_states"):
        assert torch.equal(getattr(got, name), getattr(again, name))


@pytest.mark.parametrize("monotonic", [True, False])
def test_fused_decode_longest_text(dev, monotonic):
    """Tk = 511, the longest text a 512-row key position table allows,
    monotonic (window over a few keys) and not (every key)."""
    cfg, pd, enc, pos, lengths = _decoder(dev, width=32, Tk=511, B=2,
                                          monotonic=monotonic)
    assert pd["embed_keys_positions"]["w"].shape[0] == 512
    fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    mask = core.get_mask_from_lengths(lengths, 511)
    args = (pd, cfg.decoder, fi, mask, torch.zeros(2, 16, device=dev), 9, 2)
    _close(fd.fused_decode(*args, early_exit=False),
           fd.fused_decode_plain(*args, early_exit=False), 1e-4)


@pytest.mark.parametrize("grid", [8, 114])
def test_fused_decode_small_grid_carry(dev, grid):
    """A grid smaller than the SM count (8 blocks: many column quads a
    block, weights read from device memory; 114 blocks), over a carry
    hand-off, against the plain decode."""
    cfg, pd, enc, pos, lengths = _decoder(dev, width=64, B=5, Tk=16)
    fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    mask = core.get_mask_from_lengths(lengths, 16)
    init = torch.zeros(5, 16, device=dev)
    dec = fd.FusedDecoder(pd, cfg.decoder, fi, mask, 10, grid=grid)
    assert dec.layout.grid == grid
    carry, outs = dec.zero_carry(init), dec.new_outputs(10)
    dec.launch(carry, outs, 0, 3)
    dec.launch(carry, outs, 3, 7)
    got = fd.FusedDecodeOut(*outs, 10, dec.last_attended(carry))
    _close(got, fd.fused_decode_plain(pd, cfg.decoder, fi, mask, init, 10, 2,
                                      early_exit=False), 1e-4)


def test_fused_decode_grid_not_coresident_raises(dev):
    """A grid the card cannot hold at once (more than four 512-thread
    blocks an SM) fails at launch with the CUDA error, never runs."""
    cfg, pd, enc, pos, lengths = _decoder(dev)
    fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    sms = fd.device_info(dev)[0]
    dec = fd.FusedDecoder(pd, cfg.decoder, fi, None, 4, grid=4 * sms + 1)
    carry, outs = dec.zero_carry(torch.zeros(3, 16, device=dev)), \
        dec.new_outputs(4)
    with pytest.raises(RuntimeError, match="fused_decode launch"):
        dec.launch(carry, outs, 0, 4)


@pytest.mark.parametrize("name", ["deepvoice3", "nyanko",
                                  "deepvoice3_multispeaker"])
def test_teacher_forced_b1_matches_plain_and_forward(dev, name):
    """decoder_decode(test_inputs=) launches B1 once a frame (T launches)
    and agrees with B1's plain version on the card and with the offline
    decoder_apply under conv_mode("kernel") (B3), monotonic attention off:
    1e-4 of each output's scale (the other B1 tests' bar)."""
    r = 1 if name == "nyanko" else 4
    kw = dict(n_vocab=149, embed_dim=32, mel_dim=16, linear_dim=65, r=r,
              downsample_step=4, kernel_size=3, encoder_channels=32,
              decoder_channels=32, converter_channels=32,
              use_memory_mask=True, max_positions=64,
              force_monotonic_attention=False)
    if name != "nyanko":
        kw.update(key_projection=True, value_projection=True)
    if name == "deepvoice3_multispeaker":
        kw.update(n_speakers=5, speaker_embed_dim=8)
    cfg = getattr(builder, name)(**kw)
    params = builder.model_init(cfg, torch.Generator().manual_seed(0), dev)
    g = torch.Generator().manual_seed(1)
    B, Tk, T = 2, 12, 10
    lengths = torch.tensor([Tk, Tk - 4])
    pos = torch.arange(1, Tk + 1)[None].repeat(B, 1)
    valid = pos <= lengths[:, None]
    text = torch.randint(1, 149, (B, Tk), generator=g) * valid
    pos = pos * valid
    frames = torch.rand(B, T, 16 * r, generator=g)
    text, pos, lengths, frames = (a.to(dev) for a in (text, pos, lengths,
                                                      frames))
    se = builder.embed_speakers(
        params, cfg, torch.tensor([1, 3], device=dev)
        if cfg.n_speakers > 1 else None)
    fam, dc = cfg.family, cfg.decoder
    enc = fam.encoder_apply(params["encoder"], cfg.encoder, text,
                            speaker_embed=se)
    fd.KERNEL.reset_counts()
    got = fam.decoder_decode(params["decoder"], dc, enc, pos,
                             speaker_embed=se, lengths=lengths,
                             test_inputs=frames)
    assert fd.KERNEL.by_entry == {"chunk": T}
    fi = fam.fused_decode_inputs(params["decoder"], dc, enc, pos, T,
                                 speaker_embed=se)
    want = fd.fused_decode_plain(params["decoder"], dc, fi,
                                 core.get_mask_from_lengths(lengths, Tk),
                                 None, T, dc.min_decoder_steps,
                                 test_inputs=frames)
    assert got.num_steps == want.num_steps == T
    for name in ("outputs", "alignments", "done", "decoder_states"):
        a, b = getattr(got, name), getattr(want, name)
        d = float((a - b).abs().max())
        assert d <= 1e-4 * max(1.0, float(b.abs().max())), (name, d)
    conv_cuda.KERNEL.reset_counts()
    with core.conv_mode("kernel"):
        enc_k = fam.encoder_apply(params["encoder"], cfg.encoder, text,
                                  speaker_embed=se)
        off = fam.decoder_apply(
            params["decoder"], dc, enc_k, frames, text_positions=pos,
            frame_positions=torch.arange(1, T + 1, device=dev)[None].repeat(
                B, 1), speaker_embed=se, lengths=lengths)
    assert conv_cuda.KERNEL.launches > 0
    for name, a, b in (("outputs", got.outputs, off[0]),
                       ("decoder_states", got.decoder_states, off[3]),
                       ("done", got.done, off[2][..., 0]),
                       ("alignments", got.alignments, off[1].mean(0))):
        d = float((a - b).abs().max())
        assert d <= 1e-4 * max(1.0, float(b.abs().max())), (name, d)


def test_tiny_batcher_gpu_matches_cpu(dev):
    """A tiny model's ContinuousBatcher on the card (B1's serving modes,
    B2's stream modes) against the same submit/step schedule on the CPU:
    decoded steps and lengths exact, audio 0.12 of the peak (the bar of
    the tiny stream above); one B1 launch per step."""
    from deepvoice3_pytorch_tpu_torch import hparams, serving
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu_torch.frontend import en

    cfg = builder.deepvoice3(
        n_vocab=en.n_vocab, embed_dim=32, mel_dim=16, linear_dim=65, r=1,
        downsample_step=4, kernel_size=3, encoder_channels=32,
        decoder_channels=32, converter_channels=32, use_memory_mask=True,
        key_projection=True, value_projection=True, max_positions=64)
    params = builder.model_init(cfg, torch.Generator().manual_seed(7),
                                device="cpu")
    hp = hparams.default_hparams()
    hp.fft_size, hp.hop_size = 128, 32
    ap = AudioProcessor(hp)
    texts = ["Hello streaming world.", "A second, longer sentence here."]
    runs = []
    for p in (params, params.to(dev)):
        b = serving.ContinuousBatcher(p, cfg, ap, en, n_slots=3, text_pad=16,
                                      chunk=8, max_decoder_steps=32,
                                      gl_context=8)
        fd.KERNEL.reset_counts()
        gl_cuda.KERNEL.reset_counts()
        qa = b.submit(texts[0])
        b.step()
        qb = b.submit(texts[1])
        while b.step():
            pass
        runs.append([_drain_queue(q) for q in (qa, qb)])
    assert fd.KERNEL.by_entry == {"slots": b._steps_run}
    assert gl_cuda.KERNEL.launches > 0
    for (a_g, n_g), (a_c, n_c) in zip(*runs[::-1]):
        assert n_g == n_c and a_g.shape == a_c.shape
        peak = max(float(abs(a_c).max()), 1e-6)
        assert float(abs(a_g - a_c).max()) <= 0.12 * peak


def _drain_queue(q):
    audio = []
    while True:
        kind, payload = q.get_nowait()
        assert kind != "error", payload
        if kind == "end":
            return np.concatenate(audio), payload
        audio.append(payload)


@pytest.mark.parametrize("fft,hop,B,n,n_iters,phase_init,route", [
    (1024, 256, 2, 37, 0, "spsi", "window"),
    (1024, 256, 2, 37, 1, "spsi", "window"),
    (1024, 256, 3, 21, 1, "zero", "window"),
    (128, 32, 2, 40, 1, "spsi", "window"),
    (1024, 256, 1, 40, 1, "spsi", "window"),
    (1024, 256, 1, 57, 1, "spsi", "window"),
    (1024, 256, 1, 152, 1, "spsi", "window"),
    (1024, 256, 8, 152, 1, "spsi", "window"),    # 128 x 128 window tiles
    (1024, 256, 12, 379, 1, "spsi", "batch"),    # B*n off the 128-row tile
    (1024, 256, 12, 379, 0, "zero", "batch")])
def test_griffin_lim_kernel_matches_plain(dev, fft, hop, B, n, n_iters,
                                          phase_init, route):
    """Where little amplifies bf16 rounding flips (<= 1 iteration) the
    kernel and the plain version agree to 3e-3 of the peak (one iteration
    measured 1.1e-3 on the card; the CPU tests see 7e-4 against the Pallas
    kernel); B*n is not a multiple of the GEMM tiles; each shape takes the
    route its plan names, and two runs are bit-equal."""
    g = torch.Generator().manual_seed(0)
    S = (torch.rand(B, n, fft // 2 + 1, generator=g) ** 2).to(dev)
    win = dsp.lws_hann_window(fft, hop)
    gl_cuda.KERNEL.reset_counts()
    got = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=n_iters,
                              phase_init=phase_init)
    assert gl_cuda.KERNEL.launches == 1
    assert gl_cuda.KERNEL.by_route == {route: 1}
    again = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=n_iters,
                                phase_init=phase_init)
    assert torch.equal(got, again)
    want = gl_cuda.griffin_lim_plain(S, fft, hop, win, n_iters=n_iters,
                                     phase_init=phase_init)[:, :n * hop]
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 3e-3, rel


@pytest.mark.parametrize("fft,hop,B,n,n_iters", [
    (1024, 256, 2, 37, 0), (1024, 256, 2, 37, 1), (128, 32, 3, 21, 1),
    (1024, 256, 12, 379, 1)])                    # the batch route
def test_griffin_lim_unfolded_kernel_matches_plain(dev, fft, hop, B, n,
                                                   n_iters):
    """The probe kernel P (windows applied in f32 outside the bf16 DFT
    matrices), SPSI start, at the bar of the folded schedule above."""
    g = torch.Generator().manual_seed(1)
    S = (torch.rand(B, n, fft // 2 + 1, generator=g) ** 2).to(dev)
    win = dsp.lws_hann_window(fft, hop)
    gl_cuda.KERNEL.reset_counts()
    got = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=n_iters,
                              fold_windows=False)
    assert gl_cuda.KERNEL.by_entry == {"unfolded": 1}
    assert gl_cuda.KERNEL.by_route == {
        gl_cuda.gl_plan(B, n, fft, hop).route: 1}
    want = gl_cuda.griffin_lim_plain(S, fft, hop, win, n_iters=n_iters,
                                     fold_windows=False)[:, :n * hop]
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 3e-3, rel


@pytest.mark.parametrize("B,n,n_pinned,n_iters,fold,zero_rows", [
    (2, 37, 0, 2, True, False),     # a given start without pinning
    (2, 37, 37, 2, True, False),    # every frame pinned
    (1, 152, 16, 2, True, True),    # B = 1 at a stream window's length,
                                    # pinned and free rows of zeros
    (3, 21, 5, 1, False, False),    # unfolded; B*n off the 64-row tile
    (1, 152, 152, 2, True, False),  # a window with every frame pinned
    (12, 379, 16, 1, True, False),  # the batch route
])
def test_griffin_lim_stream_modes_match_plain(dev, B, n, n_pinned, n_iters,
                                              fold, zero_rows):
    """init_spec / n_pinned / return_spec on the card. Waveform 3e-3 of the
    peak as above; the returned bf16 spectrum 2^-8 (bf16's precision) in
    relative L2 norm; pinned frames bit-equal to the kernel's own start
    (its spectrum after 0 iterations); a start of zeros (the 1e-30 guard)
    gives zeros, not NaN; two runs bit-equal."""
    fft, hop = 1024, 256
    g = torch.Generator().manual_seed(2)
    S = (torch.rand(B, n, fft // 2 + 1, generator=g) ** 2).to(dev)
    init = [torch.randn(B, n, fft // 2 + 1, generator=g).to(dev)
            for _ in range(2)]
    if zero_rows:
        for a in init:
            a[:, 3] = 0.0
            a[:, n - 5] = 0.0
    win = dsp.lws_hann_window(fft, hop)
    kw = dict(init_spec=tuple(init), n_pinned=n_pinned, return_spec=True,
              fold_windows=fold)
    gl_cuda.KERNEL.reset_counts()
    wav, spec = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=n_iters, **kw)
    _, start = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=0, **kw)
    mode = "unfolded" if not fold else "pinned" if n_pinned else "init"
    assert gl_cuda.KERNEL.by_entry == {mode: 2}
    want, want_spec = gl_cuda.griffin_lim_plain(S, fft, hop, win,
                                                n_iters=n_iters, **kw)
    want = want[:, :n * hop]
    assert torch.isfinite(wav).all()
    rel = float((wav - want).abs().max() / want.abs().max())
    assert rel <= 3e-3, rel
    c_got = torch.complex(*spec)
    c_want = torch.complex(*want_spec)
    assert float((c_got - c_want).abs().norm() / c_want.abs().norm()) \
        <= 2.0 ** -8
    for got, st in zip(spec, start):
        assert torch.equal(got[:, :n_pinned], st[:, :n_pinned])
    if zero_rows:
        for got in spec:
            assert torch.equal(got[:, 3], torch.zeros_like(got[:, 3]))
    wav2, spec2 = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=n_iters,
                                      **kw)
    assert torch.equal(wav, wav2) and all(
        torch.equal(a, b) for a, b in zip(spec, spec2))


@pytest.mark.parametrize("B,n,n_ctx,n_iters", [
    (1, 152, 16, 2), (1, 40, 0, 2), (3, 57, 8, 1), (12, 379, 16, 1)])
def test_griffin_lim_anchored_start_matches_plain(dev, B, n, n_ctx,
                                                  n_iters):
    """The anchored start (a streaming window's, computed in the kernel)
    against its plain version: on the card bit-equal (the kernel rounds
    each operation as torch does there, the SPSI cumsum in f64 included);
    against the plain version on the CPU, 2^-8 in relative L2 norm and at
    most 1 in 1000 of the start's bf16 values different (only an ulp of
    the two devices' cos, sin, atan2 or rsqrt can move a bf16 rounding).
    The iterations from that start against the plain version's at the bars
    of the stream modes above (waveform 3e-3 of the peak, returned spectrum
    2^-8); the context frames bit-equal to the start. The context is a
    slice of a larger spectrum, as the vocoders pass it."""
    fft, hop = 1024, 256
    g = torch.Generator().manual_seed(3)
    S = (torch.rand(B, n, fft // 2 + 1, generator=g) ** 2).to(dev)
    ctx = None
    if n_ctx:
        full = [torch.randn(B, n + 4, fft // 2 + 1, generator=g).to(dev)
                for _ in range(2)]
        ctx = tuple(a[:, 2:2 + n_ctx] for a in full)
    win = dsp.lws_hann_window(fft, hop)
    kw = dict(phase_init="anchored", context_spec=ctx, return_spec=True)
    gl_cuda.KERNEL.reset_counts()
    wav, spec = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=n_iters, **kw)
    _, start = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=0, **kw)
    assert gl_cuda.KERNEL.by_entry == {"pinned" if n_ctx else "init": 2}
    _, want_start = gl_cuda.griffin_lim_plain(S, fft, hop, win, n_iters=0,
                                              **kw)
    for a, b in zip(start, want_start):
        assert torch.equal(a, b)
    _, cpu_start = gl_cuda.griffin_lim_plain(
        S.cpu(), fft, hop, win, n_iters=0, **dict(
            kw, context_spec=None if ctx is None
            else tuple(a.cpu() for a in ctx)))
    c_got, c_cpu = torch.complex(*start).cpu(), torch.complex(*cpu_start)
    assert float((c_got - c_cpu).abs().norm() / c_cpu.abs().norm()) \
        <= 2.0 ** -8
    differ = sum(float((a.cpu() != b).double().mean())
                 for a, b in zip(start, cpu_start)) / 2
    assert differ <= 1e-3, differ
    want, want_spec = gl_cuda.griffin_lim_plain(
        S, fft, hop, win, n_iters=n_iters, **kw)
    want = want[:, :n * hop]
    rel = float((wav - want).abs().max() / want.abs().max())
    assert rel <= 3e-3, rel
    c_got, c_want = torch.complex(*spec), torch.complex(*want_spec)
    assert float((c_got - c_want).abs().norm() / c_want.abs().norm()) \
        <= 2.0 ** -8
    for got, st in zip(spec, start):
        assert torch.equal(got[:, :n_ctx], st[:, :n_ctx])


@pytest.mark.parametrize("B,n", [(1, 40), (1, 152), (8, 152)])
def test_griffin_lim_window_route_one_launch_equals_steps(dev, B, n):
    """The window route's one cooperative launch and its steps launched one
    by one run the same tiles and sums: bit-equal."""
    fft, hop = 1024, 256
    g = torch.Generator().manual_seed(4)
    S = (torch.rand(B, n, fft // 2 + 1, generator=g) ** 2).to(dev)
    win = dsp.lws_hann_window(fft, hop)
    plan = gl_cuda.gl_plan(B, n, fft, hop)
    assert plan.route == "window" and plan.one_launch
    mats = gl_cuda.gl_mats(fft, win, dev)
    one = gl_cuda._griffin_lim_cuda(S, fft, hop, win, mats=mats, n_iters=3,
                                    plan=plan)
    steps = gl_cuda._griffin_lim_cuda(S, fft, hop, win, mats=mats,
                                      n_iters=3,
                                      plan=plan._replace(one_launch=False))
    assert torch.equal(one, steps)


def test_tiny_stream_gpu_matches_cpu(dev):
    """A tiny model's tts_stream on the card (B1, B2's stream modes)
    against the same stream on the CPU (plain versions): decoded steps and
    chunk sizes exact, linear frames 1e-4, audio 0.12 of the peak (two bf16
    Griffin-Lim schedules with their sums in another order, amplified by 32
    iterations a window)."""
    from deepvoice3_pytorch_tpu_torch import hparams, streaming
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu_torch.frontend import en

    cfg = builder.deepvoice3(
        n_vocab=en.n_vocab, embed_dim=32, mel_dim=16, linear_dim=65, r=1,
        downsample_step=4, kernel_size=3, encoder_channels=32,
        decoder_channels=32, converter_channels=32, use_memory_mask=True,
        key_projection=True, value_projection=True, max_positions=64)
    params = builder.model_init(cfg, torch.Generator().manual_seed(7),
                                device="cpu")
    hp = hparams.default_hparams()
    hp.fft_size, hp.hop_size = 128, 32
    ap = AudioProcessor(hp)
    texts = ["Hello streaming world.", "A second, longer sentence here."]
    kw = dict(max_decoder_steps=40, emit_linear=True)
    ref = list(streaming.tts_stream(params, cfg, ap, en, texts, **kw))
    fd.KERNEL.reset_counts()
    gl_cuda.KERNEL.reset_counts()
    got = list(streaming.tts_stream(params.to(dev), cfg, ap, en, texts, **kw))
    assert fd.KERNEL.launches > 0 and gl_cuda.KERNEL.by_entry.get("pinned")
    assert [c["audio"].shape for c in got] == [c["audio"].shape for c in ref]
    assert (got[-1]["decoded_steps"] == ref[-1]["decoded_steps"]).all()
    for g_, r_ in zip(got, ref):
        assert float(abs(g_["linear"] - r_["linear"]).max()) <= 1e-4
        peak = max(float(abs(r_["audio"]).max()), 1e-6)
        assert float(abs(g_["audio"] - r_["audio"]).max()) <= 0.12 * peak


def _spectral_convergence(wav, lin, ap):
    """|| |STFT(wav)| - S || / || S || for the magnitudes S Griffin-Lim was
    given (lws framing), the waveform pre-emphasised back first."""
    x = torch.from_numpy(wav).double()
    x = torch.cat([x[:, :1], x[:, 1:] - ap.preemphasis_coef * x[:, :-1]], 1)
    win = torch.from_numpy(dsp.lws_hann_window(ap.fft_size, ap.hop_size))
    M = torch.abs(dsp.stft(dsp.lws_pad(x.float(), ap.fft_size, ap.hop_size),
                           ap.fft_size, ap.hop_size, win))
    S = ap._denorm_pow(torch.from_numpy(lin))
    n = S.shape[1]
    return (torch.linalg.norm(M[:, :n] - S, dim=(1, 2))
            / torch.linalg.norm(S, dim=(1, 2)))


@pytest.mark.parametrize("name,speaker_ids", [
    ("nyanko", None), ("deepvoice3_multispeaker", [3, 0])])
def test_tiny_family_stream_gpu_matches_cpu(dev, name, speaker_ids):
    """A tiny nyanko or multi-speaker model's tts_stream on the card (B1's
    new modes, B2's stream modes) against the same stream on the CPU:
    decoded steps and chunk sizes exact, linear frames 1e-4, spectral
    convergence of the audio within 1.05x of the CPU's (a tiny random
    nyanko makes nearly flat spectra, on which two bf16 Griffin-Lim
    schedules part by more than the 0.12 of the peak held above)."""
    from deepvoice3_pytorch_tpu_torch import hparams, streaming
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu_torch.frontend import en

    kw = dict(n_vocab=en.n_vocab, embed_dim=32, mel_dim=16, linear_dim=65,
              r=1, downsample_step=4, kernel_size=3, encoder_channels=32,
              decoder_channels=32, converter_channels=32,
              use_memory_mask=True, max_positions=64)
    if speaker_ids:
        kw.update(n_speakers=5, speaker_embed_dim=8, key_projection=True,
                  value_projection=True)
    else:
        kw.update(use_decoder_state_for_postnet_input=True)
    cfg = getattr(builder, name)(**kw)
    params = builder.model_init(cfg, torch.Generator().manual_seed(7),
                                device="cpu")
    hp = hparams.default_hparams()
    hp.fft_size, hp.hop_size = 128, 32
    ap = AudioProcessor(hp)
    texts = ["Hello streaming world.", "A second, longer sentence here."]
    skw = dict(max_decoder_steps=40, emit_linear=True,
               speaker_ids=speaker_ids)
    ref = list(streaming.tts_stream(params, cfg, ap, en, texts, **skw))
    fd.KERNEL.reset_counts()
    gl_cuda.KERNEL.reset_counts()
    got = list(streaming.tts_stream(params.to(dev), cfg, ap, en, texts,
                                    **skw))
    assert fd.KERNEL.launches > 0 and gl_cuda.KERNEL.by_entry.get("pinned")
    assert [c["audio"].shape for c in got] == [c["audio"].shape for c in ref]
    assert (got[-1]["decoded_steps"] == ref[-1]["decoded_steps"]).all()
    for g_, r_ in zip(got, ref):
        assert float(abs(g_["linear"] - r_["linear"]).max()) <= 1e-4
    lin = np.concatenate([c["linear"] for c in ref], axis=1)
    sc = [_spectral_convergence(np.concatenate([c["audio"] for c in run], 1),
                                lin, ap) for run in (got, ref)]
    assert bool((sc[0] <= 1.05 * sc[1]).all()), sc


def test_griffin_lim_kernel_rejects_bad_framing(dev):
    S = torch.rand(1, 8, 513, device=dev)
    with pytest.raises(ValueError):
        gl_cuda.griffin_lim(S, 1024, 240, torch.ones(1024).numpy())


CONV_CASES = [  # B, T, C, N, kw, dil, causal, fast route (C, N % 8 == 0)
    (2, 37, 20, 70, 3, 1, False, False),    # T, C, N off every tile
    (1, 130, 64, 128, 3, 3, True, True),     # B = 1, causal
    (3, 40, 16, 24, 3, 27, False, True),     # dilation 27, T < 54: taps in the pad
    (2, 40, 16, 24, 3, 27, True, True),      # the same, causal
    (2, 300, 256, 512, 3, 9, True, True),    # decoder width, several row tiles
    (4, 33, 24, 8, 5, 1, False, True),       # kw 5, N below one tile
    (3, 200, 64, 136, 3, 3, False, True),    # ragged last tile of every item
    (2, 128, 64, 64, 3, 9, False, True),     # T exactly one tile
    (2, 128, 512, 1024, 3, 9, False, True),  # the encoder class at B = 2
    (2, 37, 12, 20, 3, 1, False, False),     # 24-byte bf16 rows; f32 takes the pipe
]


def _conv_inputs(dev, B, T, C, N, kw, dil, causal, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, C, generator=g)
    w = torch.randn(kw, C, N, generator=g) / (kw * C) ** 0.5
    b = torch.randn(N, generator=g) * 0.1
    dy = torch.randn(B, T, N, generator=g)
    pad = ((kw - 1) * dil, 0) if causal else ((kw - 1) // 2 * dil,) * 2
    return [a.to(dev, dtype) for a in (x, w, b, dy)] + [pad]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,N,kw,dil,causal,fast", CONV_CASES)
def test_conv_taps_kernel_matches_plain(dev, dtype, B, T, C, N, kw, dil,
                                        causal, fast):
    """Forward, dgrad and wgrad kernels against the plain versions on the
    same card, through the route the shape selects (counted per route).
    f32: 1e-5 of the output's scale (the kernel's FMA order against the
    plain matmul's). bf16: the plain version computes in f32 from the same
    bf16 operands and rounds once, so the bar is one bf16 ulp of the
    largest value (2^-7 relative) for the bf16 outputs and 1e-5 for the
    f32 weight gradient."""
    x, w, b, dy, pad = _conv_inputs(dev, B, T, C, N, kw, dil, causal, dtype)
    route = conv_cuda.route(C, N, dtype)
    if dtype == torch.bfloat16:
        assert route == ("wgmma" if fast else "simple")
    else:
        assert route == ("pipe" if C % 4 == 0 and N % 4 == 0 else "simple")
    conv_cuda.KERNEL.reset_counts()
    pairs = [
        (conv_cuda.conv_fwd(x, w, b, pad, dil),
         conv_cuda.conv1d_taps_plain(x, w, b, pad, dil), dtype),
        (conv_cuda.conv_dgrad(dy, w, pad, dil),
         conv_cuda.conv1d_taps_plain(dy, w.flip(0).transpose(1, 2), None,
                                     (pad[1], pad[0]), dil), dtype),
        (conv_cuda.conv_wgrad(x, dy, pad, dil, kw),
         conv_cuda.conv1d_taps_wgrad_plain(x, dy, pad, dil, kw),
         torch.float32),
    ]
    torch.cuda.synchronize()
    assert conv_cuda.KERNEL.by_entry == {"fwd_" + route: 2,
                                         "wgrad_" + route: 1}
    for got, want, out_dtype in pairs:
        assert got.dtype == out_dtype and got.shape == want.shape
        scale = max(1.0, float(want.float().abs().max()))
        tol = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("B,T,C,N,dil,causal,tile_n", [
    (2, 300, 256, 512, 9, True, 256),    # ragged last time tile
    (3, 40, 16, 24, 27, True, 256),      # taps in the pad, N below the tile
    (2, 128, 64, 136, 3, False, 256),    # one ragged column tile
    (2, 130, 64, 72, 1, False, 128),
])
def test_conv_taps_bf16_tile_widths_match_plain(dev, B, T, C, N, dil, causal,
                                                tile_n):
    """The bf16 forward (the weight read in place, "in, out") and dgrad
    (its taps read in reverse) at either tile width (fwd_plan picks 256
    columns only from half a wave of blocks, so small shapes name it here):
    the bf16 bar of test_conv_taps_kernel_matches_plain."""
    x, w, b, dy, pad = _conv_inputs(dev, B, T, C, N, 3, dil, causal,
                                    torch.bfloat16)
    pairs = [
        (conv_cuda._launch_fwd(x, w, b, pad[0], dil, False, tile_n),
         conv_cuda.conv1d_taps_plain(x, w, b, pad, dil)),
        (conv_cuda._launch_fwd(dy, w, None, pad[1], dil, True, tile_n),
         conv_cuda.conv1d_taps_plain(dy, w.flip(0).transpose(1, 2), None,
                                     (pad[1], pad[0]), dil)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        scale = max(1.0, float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) <= \
            2.0 ** -7 * scale


@pytest.mark.parametrize("dtype,tile_n", [
    (torch.float32, 256), (torch.float32, 32),
    (torch.bfloat16, 64), (torch.bfloat16, 512)])
def test_conv_taps_fwd_refuses_other_tile_widths(dev, dtype, tile_n):
    """The fast forward launches only the tile widths it was built for; any
    other raises and counts no launch."""
    x, w, b, dy, pad = _conv_inputs(dev, 2, 130, 64, 72, 3, 1, False, dtype)
    conv_cuda.KERNEL.reset_counts()
    with pytest.raises(RuntimeError, match="forward launch"):
        conv_cuda._launch_fwd(x, w, b, pad[0], 1, False, tile_n)
    assert conv_cuda.KERNEL.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_taps_wgrad_is_deterministic(dev, dtype):
    """Split rows summed in a fixed order, no atomics: bit-equal runs on
    the fast route."""
    x, w, b, dy, pad = _conv_inputs(dev, 8, 200, 256, 512, 3, 3, False,
                                    dtype)
    plan = conv_cuda.wgrad_plan(8, 200, 256, 512, 3, dtype)
    assert plan.splits > 1 and plan.route != "simple"
    conv_cuda.KERNEL.reset_counts()
    a = conv_cuda.conv_wgrad(x, dy, pad, 3, 3)
    c = conv_cuda.conv_wgrad(x, dy, pad, 3, 3)
    assert conv_cuda.KERNEL.by_entry == {"wgrad_" + plan.route: 2}
    assert torch.equal(a, c)


def test_conv_taps_autograd_runs_three_kernels(dev):
    """One differentiable conv: forward, then dgrad + wgrad in backward;
    gradients equal the plain version's through autograd."""
    x, w, b, dy, pad = _conv_inputs(dev, 2, 50, 32, 64, 3, 1, True,
                                    torch.float32)
    leaves = [a.clone().requires_grad_(True) for a in (x, w, b)]
    conv_cuda.KERNEL.reset_counts()
    conv_cuda.conv1d_taps(*leaves, pad, 1).backward(dy)
    assert conv_cuda.KERNEL.by_entry == {"fwd_pipe": 2, "wgrad_pipe": 1}
    ref = [a.clone().requires_grad_(True) for a in (x, w, b)]
    conv_cuda.conv1d_taps_plain(*ref, pad, 1).backward(dy)
    for got, want in zip(leaves, ref):
        assert torch.allclose(got.grad, want.grad, rtol=1e-5, atol=1e-5)


def test_conv_taps_kernel_rejects_bad_calls(dev):
    x = torch.zeros(1, 8, 4, device=dev)
    w = torch.zeros(3, 4, 4, device=dev)
    with pytest.raises(ValueError):
        conv_cuda.conv1d_taps(x, w, None, (1, 0), 1)
    with pytest.raises(TypeError):
        conv_cuda.conv_fwd(x.half(), w.half(), None, (1, 1), 1)
    with pytest.raises(ValueError):
        conv_cuda.conv_fwd(x, w.to(torch.bfloat16), None, (1, 1), 1)


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A multi-speaker model's parameters and Adam moments after a step on
    the card, saved synchronously and asynchronously (the moments changed
    in place right after the submit) and loaded into another model on the
    card: every tensor bit-equal, still on the card, and the two files
    equal."""
    from deepvoice3_pytorch_tpu_torch.hparams import default_hparams
    from deepvoice3_pytorch_tpu_torch.training import checkpoint as ck
    from deepvoice3_pytorch_tpu_torch.training import trainer

    kw = dict(n_vocab=149, embed_dim=32, mel_dim=16, linear_dim=65, r=1,
              downsample_step=4, dropout=0.0, kernel_size=3,
              encoder_channels=32, decoder_channels=32, converter_channels=32,
              n_speakers=5, speaker_embed_dim=8, max_positions=64)
    cfg = builder.deepvoice3_multispeaker(**kw)
    hp = default_hparams()
    hp.fft_size, hp.num_mels = 128, 16
    opt = trainer.make_optimizer(hp, trainer.make_lr_fn(hp))
    params = builder.model_init(cfg, torch.Generator().manual_seed(1), dev)
    step = trainer.make_train_step(cfg, trainer.loss_config_from_hparams(hp),
                                   opt, trainer.trainable_mask(params, cfg))
    state = trainer.init_train_state(params, opt)
    rs = np.random.RandomState(3)
    batch = trainer.batch_to({
        "x": rs.randint(1, 149, (2, 12)),
        "input_lengths": np.asarray([12, 9]),
        "mel": rs.rand(2, 16, 16).astype(np.float32),
        "y": rs.rand(2, 64, 65).astype(np.float32),
        "text_positions": np.tile(np.arange(1, 13), (2, 1)),
        "frame_positions": np.tile(np.arange(1, 17), (2, 1)),
        "done": np.zeros((2, 16, 1), np.float32),
        "target_lengths": np.asarray([64, 48]),
        "speaker_ids": np.asarray([1, 4])}, dev)
    state, _ = step(state, batch, torch.Generator(device=dev).manual_seed(0))
    sync = ck.save_checkpoint(str(tmp_path / "sync"), state.params,
                              state.opt_state, 1, 0)
    path = ck.save_checkpoint(str(tmp_path / "async"), state.params,
                              state.opt_state, 1, 0, async_save=True)
    saved = [m.clone() for m in state.opt_state.mu.values()]
    torch._foreach_mul_(list(state.opt_state.mu.values()), 2.0)
    ck.wait_pending_saves()
    torch._foreach_copy_(list(state.opt_state.mu.values()), saved)
    assert open(path, "rb").read() == open(sync, "rb").read()

    other = builder.model_init(cfg, torch.Generator().manual_seed(2), dev)
    template = trainer.init_train_state(other, opt).opt_state
    other, opt_state, gstep, _ = ck.load_checkpoint(path, other, template)
    assert gstep == 1 and opt_state.count == 1
    want = state.params.state_dict()
    for k, v in other.state_dict().items():
        assert v.device == dev and torch.equal(v, want[k]), k
        for a, b in ((opt_state.mu, state.opt_state.mu),
                     (opt_state.nu, state.opt_state.nu)):
            assert a[k].device == dev and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("B,n,n_iters,route", [
    (2, 37, 1, "window"), (1, 152, 1, "window"), (12, 379, 1, "batch"),
    (12, 379, 0, "batch")])
def test_griffin_lim_center_kernel_matches_plain(dev, B, n, n_iters, route):
    """B2 in the centred framing (sqrt-Hann folded, the fft // 2 trim)
    against the plain version's untrimmed signal from fft // 2 on: 3e-3 of
    the peak at <= 1 iteration, counted as "center", two runs bit-equal."""
    g = torch.Generator().manual_seed(1)
    S = (torch.rand(B, n, 513, generator=g) ** 2).to(dev)
    win = dsp.sqrt_hann_window(1024)
    gl_cuda.KERNEL.reset_counts()
    got = gl_cuda.griffin_lim(S, 1024, 256, win, n_iters=n_iters, center=True)
    assert gl_cuda.KERNEL.by_entry == {"center": 1}
    assert gl_cuda.KERNEL.by_route == {route: 1}
    assert torch.equal(got, gl_cuda.griffin_lim(S, 1024, 256, win,
                                                n_iters=n_iters, center=True))
    want = gl_cuda.griffin_lim_plain(S, 1024, 256, win, n_iters=n_iters)[
        :, 512:512 + n * 256]
    assert got.shape == want.shape
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 3e-3, rel


@pytest.mark.parametrize("center", [False, True])
def test_general_griffin_lim_card_matches_cpu(dev, center):
    """The plain general-hop loop (hop 240) on the card against the CPU:
    one iteration within 2 bf16 ulps of the peak."""
    g = torch.Generator().manual_seed(2)
    S = torch.rand(2, 60, 513, generator=g) ** 2
    win = (dsp.sqrt_hann_window(1024) if center
           else dsp.lws_hann_window(1024, 240))
    got = dsp.griffin_lim(S.to(dev), 1024, 240, win, n_iters=1,
                          center=center).cpu()
    want = dsp.griffin_lim(S, 1024, 240, win, n_iters=1, center=center)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 2 * 2.0 ** -8, rel


def test_lws_run_card_matches_cpu(dev):
    from deepvoice3_pytorch_tpu_torch.dsp import lws_phase

    g = torch.Generator().manual_seed(3)
    S = torch.rand(2, 40, 513, generator=g) ** 2
    win = dsp.lws_hann_window(1024, 256)
    got = lws_phase.lws_run(S.to(dev), 1024, 256, win, n_iters=3).cpu()
    want = lws_phase.lws_run(S, 1024, 256, win, n_iters=3)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-4, rel


@pytest.mark.parametrize("overrides", ["stft_mode=center",
                                       "sample_rate=16000,hop_size=240"])
def test_features_card_match_cpu(dev, overrides):
    """Centred and hop-240 features on the card against the CPU: 1e-5 on
    average, one value in a thousand beyond 2e-4 (cuFFT against pocketfft
    in bins near the -100 dB floor)."""
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu_torch.hparams import default_hparams

    ap = AudioProcessor(default_hparams().parse(overrides))
    rs = np.random.RandomState(4)
    wavs = [(0.3 * rs.randn(n)).astype(np.float32) for n in (300, 9000)]
    for (lg, mg), (lc, mc) in zip(ap.batch_features(wavs, device=dev),
                                  ap.batch_features(wavs, device="cpu")):
        for a, b in ((lg, lc), (mg, mc)):
            d = np.abs(a - b)
            assert d.mean() <= 1e-5 and (d > 2e-4).mean() <= 1e-3


# kernel B2 at every framing the Pallas kernel takes (hop | fft): k = fft /
# hop up to 16, hops off 4 (the scalar overlap-add), fft off 64 (frame rows
# padded to 64) and off 8 (analysis rows padded to 8), on the route and
# tiles each shape's plan names
B2_SHAPES = [  # fft, hop, B, n, route
    (1024, 128, 2, 37, "window"),     # k = 8
    (1024, 128, 12, 379, "batch"),
    (2048, 256, 12, 379, "batch"),    # k = 8 at fft 2048
    (1024, 64, 2, 40, "window"),      # k = 16
    (800, 200, 2, 37, "window"),      # fft % 64 = 32: 64 x 32 tiles
    (800, 200, 12, 379, "window"),    # 64 x 64 (the stride 832 is off 128)
    (1100, 275, 2, 37, "window"),     # hop % 4 = 3, fft % 8 = 4
    (1100, 275, 12, 379, "window"),   # 128 x 128 tiles on the 1152 stride
    (256, 32, 3, 21, "window"),
    (200, 50, 3, 21, "window"),       # hop % 4 = 2
    (132, 33, 3, 21, "window"),
]


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("fft,hop,B,n,route", B2_SHAPES)
def test_griffin_lim_kernel_takes_every_framing(dev, fft, hop, B, n, route,
                                                fold):
    """B2 (and P, fold=False) against its plain version at 0 and 1
    iterations, SPSI start: 3e-3 of the peak, the bar of
    test_griffin_lim_kernel_matches_plain; the route the plan names; two
    runs bit-equal."""
    g = torch.Generator().manual_seed(5)
    S = (torch.rand(B, n, fft // 2 + 1, generator=g) ** 2).to(dev)
    win = dsp.lws_hann_window(fft, hop)
    assert gl_cuda.b2_takes(fft, hop)
    assert gl_cuda.gl_plan(B, n, fft, hop).route == route
    for n_iters in (0, 1):
        gl_cuda.KERNEL.reset_counts()
        got = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=n_iters,
                                  fold_windows=fold)
        assert gl_cuda.KERNEL.by_route == {route: 1}
        assert torch.equal(got, gl_cuda.griffin_lim(
            S, fft, hop, win, n_iters=n_iters, fold_windows=fold))
        want = gl_cuda.griffin_lim_plain(S, fft, hop, win, n_iters=n_iters,
                                         fold_windows=fold)[:, :n * hop]
        assert got.shape == want.shape and torch.isfinite(got).all()
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= 3e-3, (n_iters, rel)


@pytest.mark.parametrize("fft,hop,B,n,route", [
    s for s in B2_SHAPES if s[:2] in ((1024, 128), (800, 200), (1100, 275))])
def test_griffin_lim_stream_modes_take_every_framing(dev, fft, hop, B, n,
                                                     route):
    """The anchored start with a context, the pinned frames and the
    returned spectrum at the new framings, against the plain version at the
    bars of test_griffin_lim_anchored_start_matches_plain: the start
    bit-equal, the waveform 3e-3 of the peak after 2 iterations, the
    returned spectrum 2^-8 in relative L2 norm, the context frames exact."""
    F = fft // 2 + 1
    n_ctx = 8
    g = torch.Generator().manual_seed(6)
    S = (torch.rand(B, n, F, generator=g) ** 2).to(dev)
    ctx = tuple(torch.randn(B, n_ctx, F, generator=g).to(dev)
                for _ in range(2))
    win = dsp.lws_hann_window(fft, hop)
    kw = dict(phase_init="anchored", context_spec=ctx, return_spec=True)
    gl_cuda.KERNEL.reset_counts()
    wav, spec = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=2, **kw)
    _, start = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=0, **kw)
    assert gl_cuda.KERNEL.by_entry == {"pinned": 2}
    assert gl_cuda.KERNEL.by_route == {route: 2}
    _, want_start = gl_cuda.griffin_lim_plain(S, fft, hop, win, n_iters=0,
                                              **kw)
    for a, b in zip(start, want_start):
        assert torch.equal(a, b)
    want, want_spec = gl_cuda.griffin_lim_plain(S, fft, hop, win, n_iters=2,
                                                **kw)
    want = want[:, :n * hop]
    rel = float((wav - want).abs().max() / want.abs().max())
    assert rel <= 3e-3, rel
    c_got, c_want = torch.complex(*spec), torch.complex(*want_spec)
    assert float((c_got - c_want).abs().norm() / c_want.abs().norm()) \
        <= 2.0 ** -8
    for got, st in zip(spec, start):
        assert torch.equal(got[:, :n_ctx], st[:, :n_ctx])


def test_griffin_lim_refusals_read_well(dev):
    """Only a hop that does not divide fft (and a batch past 32-bit
    indexing) is refused, each with a message that formats."""
    S = torch.rand(1, 8, 513, device=dev)
    with pytest.raises(ValueError, match="divide"):
        gl_cuda.griffin_lim(S, 1024, 240, dsp.lws_hann_window(1024, 256))
    big = torch.empty(2048, 2048, 513, device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        gl_cuda._griffin_lim_cuda(big, 1024, 256,
                                  dsp.lws_hann_window(1024, 256), mats=None)


def test_tts_batch_at_hop_128_gpu_matches_cpu(dev):
    """tts_batch of a narrow LJSpeech-structure model at fft 1024 / hop 128
    (k = 8) on the card (route b2, B2 launched) against the CPU: decoded
    steps exact, audio within 1.05x of the CPU's spectral convergence."""
    import copy

    from deepvoice3_pytorch_tpu_torch import hparams, model_builder
    from deepvoice3_pytorch_tpu_torch import synthesis
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu_torch.frontend import en

    hp = hparams.default_hparams().parse(
        "text_embed_dim=32,encoder_channels=32,decoder_channels=32,"
        "converter_channels=32,hop_size=128")
    cfg, params = model_builder.build_model(hp, en.n_vocab, seed=3,
                                            device="cpu")
    texts = ["Hello world at a finer hop.", "A second sentence to batch."]
    ap_c, ap_g = AudioProcessor(hp), AudioProcessor(hp)
    ref = synthesis.tts_batch(params, cfg, ap_c, en, texts,
                              max_decoder_steps=40)
    gl_cuda.KERNEL.reset_counts()
    got = synthesis.tts_batch(copy.deepcopy(params).to(dev), cfg, ap_g, en,
                              texts, max_decoder_steps=40)
    assert ap_g.routes == {"b2": 1} and gl_cuda.KERNEL.by_entry == {"batch": 1}
    for g_, r_ in zip(got, ref):
        assert g_["num_decoder_steps"] == r_["num_decoder_steps"]
        assert g_["waveform"].shape == r_["waveform"].shape
        lin = ((r_["linear"] - ap_c.min_level_db) / -ap_c.min_level_db)[None]
        sc = [_spectral_convergence(w["waveform"][None], lin.astype(
            np.float32), ap_c) for w in (g_, r_)]
        assert float(sc[0]) <= 1.05 * float(sc[1]), sc


def test_nyanko_b1_stamps_fold_by_kind(dev):
    """One recorded nyanko tts_batch at B = 32 and the preset's widths:
    each B1 launch's stamps are kept with the kinds of its 25 stages a
    step (16 of them HIGHWAY), the kinds sum to the totals, the HIGHWAY
    share of the launches lies between 0 and 1, and the totals are those
    of the same stamps folded without kinds."""
    import json
    import os

    from deepvoice3_pytorch_tpu_torch import hparams, model_builder
    from deepvoice3_pytorch_tpu_torch import synthesis
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu_torch.frontend import en
    from deepvoice3_pytorch_tpu_torch.utils import profiling

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hp = hparams.default_hparams()
    with open(os.path.join(repo, "presets", "nyanko_ljspeech.json")) as f:
        hp.parse_json(f.read())
    cfg, params = model_builder.build_model(hp, en.n_vocab, seed=3,
                                            device=dev)
    ap = AudioProcessor(hp)
    texts = ["sentence number %d of a batch, with a few more words." % i
             for i in range(32)]

    def call():
        return synthesis.tts_batch(params, cfg, ap, en, texts,
                                   max_decoder_steps=64, early_exit=False)

    call()                                        # build the kernels
    with profiling.recording() as w:
        call()
    assert len(w.stamps) == 2                     # two chunks of 32 steps
    for _, steps, n_stages, kinds in w.stamps:
        assert n_stages == len(kinds) == 25 and steps == 32
        assert kinds.count("HIGHWAY") == 16
    split = w.b1_split()
    plain = profiling.Window()
    plain.stamps = [entry[:3] for entry in w.stamps]
    assert {k: v for k, v in split.items() if k != "kinds"} == \
        plain.b1_split()
    for k in ("work_ns", "barrier_ns"):
        assert sum(p[k] for p in split["kinds"].values()) == split[k]
    hw = split["kinds"]["HIGHWAY"]
    share = (hw["work_ns"] + hw["barrier_ns"]) / split["launch_ns"]
    assert 0 < share < 1, json.dumps(split)

    # 70 steps: two launches of 32, then a short one of the 6 left, whose
    # buffer holds 2 + 3 * 6 * 25 stamps and folds by kind as the others
    with profiling.recording() as w:
        synthesis.tts_batch(params, cfg, ap, en, texts, max_decoder_steps=70,
                            early_exit=False)
    assert [steps for _, steps, _, _ in w.stamps] == [32, 32, 6]
    buf, steps, n_stages, kinds = w.stamps[-1]
    assert buf.numel() == 2 + 3 * steps * n_stages == 2 + 3 * 6 * 25
    t = buf.cpu().numpy()
    whole = profiling.fold_b1_stamps(t, steps, n_stages)
    by_kind = profiling.fold_b1_stamps_by_kind(t, steps, n_stages, kinds)
    assert whole is not None and by_kind is not None
    for k in ("work_ns", "barrier_ns"):
        assert sum(p[k] for p in by_kind.values()) == whole[k]
    assert w.b1_split()["launches"] == 3
    assert w.counters()["b1.steps_run"] == \
        w.counters()["b1.steps_kept"] == 70


def test_tp2_forward_through_b3_matches_plain(dev, tmp_path):
    """Tensor parallelism on the card: two ranks sharing it over gloo (CUDA
    tensors staged through pinned host memory), the teacher-forced forward
    with every divisible conv and linear layer sliced over both, the convs
    through B3 at each rank's half of the out channels, against the same
    forward in one process on the CPU (B3's plain version): 1e-5 of the
    output's scale; B3 launched on the fast route on both ranks."""
    import torch_mesh_ranks as ranks

    cfg_kw = dict(n_vocab=149, embed_dim=32, mel_dim=16, linear_dim=65, r=1,
                  downsample_step=4, dropout=0.0, kernel_size=3,
                  encoder_channels=64, decoder_channels=64,
                  converter_channels=64, use_memory_mask=True,
                  key_projection=True, value_projection=True,
                  max_positions=64)
    params = builder.model_init(builder.deepvoice3(**cfg_kw),
                                torch.Generator().manual_seed(0), "cpu")
    rs = np.random.RandomState(0)
    B, T_text, T_dec = 3, 12, 10
    spec = {
        "builder": "deepvoice3", "fwd_cfg": cfg_kw, "device": "cuda",
        "fwd_params": {k: v.numpy() for k, v in params.state_dict().items()},
        "fwd_batch": {
            "x": rs.randint(1, 149, (B, T_text)),
            "mel": rs.rand(B, T_dec, 16).astype(np.float32),
            "text_positions": np.tile(np.arange(1, T_text + 1), (B, 1)),
            "frame_positions": np.tile(np.arange(1, T_dec + 1), (B, 1)),
            "input_lengths": np.asarray([12, 9, 7])}}
    want = ranks.body_tp_forward(spec, None, torch.device("cpu"))["outputs"]
    for got in ranks.spawn("tp_cuda", spec, tmp_path):
        fwd = got["tp_forward"]
        assert fwd["sharded"] and fwd["b3"].get("fwd_pipe", 0) > 0
        assert not any(e.endswith("_simple") for e in fwd["b3"])
        assert got["collectives"]["staged"] > 0
        for g, w in zip(fwd["outputs"], want):
            scale = max(1.0, float(np.abs(w).max()))
            assert np.abs(g - w).max() <= 1e-5 * scale


def test_dp_tp_over_nccl_matches_one_card(dev, tmp_path):
    """dp = 2 x tp = 2 over four cards, a process a card over NCCL: one
    train step against the same step in one process on one card (2e-6 on
    every parameter, the loss 1e-6 relative, grad_norm 1e-5: the bars of
    tests/test_torch_mesh.py), the parameters equal on every rank, and the
    checkpoint round trip (2 steps, a save through the async writer, a
    load, 3 steps) bit for bit against 5 uninterrupted steps. Needs four
    cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices, has %d"
                    % torch.cuda.device_count())
    import torch_mesh_ranks as ranks

    params = builder.model_init(builder.deepvoice3(**ranks.CFG),
                                torch.Generator().manual_seed(0), "cpu")
    spec = {"builder": "deepvoice3", "cfg": ranks.CFG, "hp": ranks.HP,
            "params": {k: v.numpy() for k, v in params.state_dict().items()},
            "batches": [ranks.batch(seed=i) for i in range(5)],
            "device": "cuda", "backend": "nccl",
            "ckpt_dir": str(tmp_path / "ck")}
    want = ranks.body_dptp_step(spec, None, dev)
    got = ranks.spawn("dptp_nccl", spec, tmp_path)
    step = got[0]["dptp_step"]
    for k, w in want["params"].items():
        assert np.abs(step["params"][k] - w).max() <= 2e-6, k
    g, w = step["metrics"][0], want["metrics"][0]
    assert abs(g["loss"] - w["loss"]) <= 1e-6 * abs(w["loss"])
    assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-5 * w["grad_norm"]
    for r in got[1:]:
        assert all(np.array_equal(r["dptp_step"]["params"][k], v)
                   for k, v in step["params"].items())
    ck = got[0]["ckpt"]
    assert [r["ckpt"]["wrote"] for r in got] == [True, False, False, False]
    assert all(np.array_equal(ck["resumed"][k], v)
               for k, v in ck["whole"].items())


def test_sp2_over_nccl_matches_one_card(dev, tmp_path):
    """Sequence parallelism on two cards, a process a card over NCCL: one
    sp = 2 step (each card a block of frames, halo exchanges around every
    kw > 1 conv, B3 on the halo-extended blocks) against the same step on
    one card: 2e-6 on every parameter, the loss 1e-6 relative, grad_norm
    1e-5 (tests/test_torch_mesh_sp.py's bars). Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices, has %d"
                    % torch.cuda.device_count())
    import torch_mesh_ranks as ranks

    params = builder.model_init(builder.deepvoice3(**ranks.CFG),
                                torch.Generator().manual_seed(0), "cpu")
    spec = {"builder": "deepvoice3", "cfg": ranks.CFG, "hp": ranks.HP,
            "params": {k: v.numpy() for k, v in params.state_dict().items()},
            "batches": [ranks.batch(seed=0)], "device": "cuda",
            "backend": "nccl"}
    with core.strict_numerics():
        want = ranks.body_sp_step(spec, None, dev)
    got = ranks.spawn("sp_nccl", spec, tmp_path)
    for r in got:
        step = r["sp_step"]
        for k, w in want["params"].items():
            assert np.abs(step["params"][k] - w).max() <= 2e-6, k
        g, w = step["metrics"][0], want["metrics"][0]
        assert abs(g["loss"] - w["loss"]) <= 1e-6 * abs(w["loss"])
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-5 * w["grad_norm"]
        assert step["b3"].get("fwd_pipe", 0) > 0
        assert r["collectives"]["halo"] > 0
        assert r["collectives"].get("staged", 0) == 0
