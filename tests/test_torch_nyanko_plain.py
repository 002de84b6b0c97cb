# coding: utf-8
"""The port's nyanko (DCTTS) against the benchmark's plain reference
(dv3bench/reference/nyanko.py: plain f32 PyTorch written from the model's
equations, importing nothing of the port and nothing of JAX) at tiny
widths on the CPU, on the same seeded weights: the text encoder's keys and
values, the teacher-forced decoder, the converter, the free-running
decode through kernel B1's plain version against the reference's step
loop, and tts_batch's mel and linear features; and B1's stamps folded by
the kind of each stage.

Tolerances: both sides run f32 on the CPU; they differ only in summation
order (the port's conv routes and the kernel's plain step against
F.conv1d and the reference's own tap sums), a few ulp a layer, so the
whole-sequence outputs are held to 1e-5 of their scale (max(1, max|x|))
through stacks of up to 16 layers. A free-running decode feeds each
frame back, so its rounding compounds over the steps: 2e-5 there, and the
argmax of each monotonic window (last_attended) and the step counts
exact."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepvoice3_pytorch_tpu_torch import builder, hparams, model_builder
from deepvoice3_pytorch_tpu_torch import synthesis
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
from deepvoice3_pytorch_tpu_torch.frontend import en
from deepvoice3_pytorch_tpu_torch.models import nyanko as nk
from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd
from deepvoice3_pytorch_tpu_torch.params import ParamTree
from deepvoice3_pytorch_tpu_torch.utils import profiling
from dv3bench.reference import nyanko as ref
from dv3bench.reference import text as ref_text
from torch_port_common import TINY_NYANKO

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 7
B, TK, T = 3, 13, 10


def _close(got, want, tol):
    d = float((got - want).abs().max())
    assert d <= tol * max(1.0, float(want.abs().max())), d


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    cfg_p = builder.nyanko(**TINY_NYANKO)
    cfg_r = ref.nyanko(**TINY_NYANKO)
    tree = ref.seeded_tree(cfg_r, SEED, "cpu")
    g = torch.Generator().manual_seed(5)
    lengths = torch.tensor([TK, TK - 4, 5])
    ids = torch.randint(2, TINY_NYANKO["n_vocab"], (B, TK), generator=g)
    pos = torch.arange(1, TK + 1).repeat(B, 1)
    valid = pos <= lengths[:, None]
    ids, pos = ids * valid, pos * valid
    return cfg_p, cfg_r, tree, ParamTree(tree), ids, pos, lengths


def test_reference_tree_is_the_ports_layout(tiny):
    """The seeded tree has the names and shapes of the port's own
    model_init, so the port runs on the reference's weights as they are."""
    cfg_p, cfg_r, tree, params = tiny[:4]
    own = builder.model_init(cfg_p, torch.Generator().manual_seed(0), "cpu")
    shapes = {k: tuple(v.shape) for k, v in own.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in params.state_dict().items()} \
        == shapes
    assert ref.leaf_shapes(cfg_r) == shapes


def test_encoder_keys_and_values(tiny):
    cfg_p, cfg_r, tree, params, ids = tiny[:5]
    with torch.no_grad():
        keys, values = nk.encoder_apply(params["encoder"], cfg_p.encoder, ids)
        rk, rv = ref.encoder(tree, cfg_r, ids)
    _close(keys, rk, 1e-5)
    _close(values, rv, 1e-5)


def test_teacher_forced_decoder(tiny):
    cfg_p, cfg_r, tree, params, ids, pos, lengths = tiny
    g = torch.Generator().manual_seed(6)
    inputs = torch.rand(B, T, cfg_r.mel_dim, generator=g)
    frame_pos = torch.arange(1, T + 1).repeat(B, 1)
    with torch.no_grad():
        enc = nk.encoder_apply(params["encoder"], cfg_p.encoder, ids)
        got = nk.decoder_apply(params["decoder"], cfg_p.decoder, enc, inputs,
                               text_positions=pos, frame_positions=frame_pos,
                               lengths=lengths)
        want = ref.decoder_forward(tree, cfg_r, *enc, inputs, pos, frame_pos,
                                   ref.padding_mask(lengths, TK))
    _close(got[0], want[0], 1e-5)           # frames
    _close(got[1][0], want[1], 1e-5)        # alignments
    _close(got[2], want[2], 1e-5)           # done
    _close(got[3], want[3], 1e-5)           # decoder states


def test_converter(tiny):
    cfg_p, cfg_r, tree, params = tiny[:4]
    g = torch.Generator().manual_seed(7)
    x = torch.randn(B, T, cfg_r.converter.in_dim, generator=g)
    with torch.no_grad():
        got = nk.converter_apply(params["converter"], cfg_p.converter, x)
        want = ref.converter(tree, cfg_r, x)
    assert got.shape == (B, 4 * T, cfg_r.linear_dim) == want.shape
    _close(got, want, 1e-5)


@pytest.mark.parametrize("chunk", [32, 4])
def test_free_running_decode_through_b1_plain(tiny, chunk):
    """Kernel B1's plain version (the CPU's route of `fused_decode`)
    decodes what the reference's step loop decodes."""
    cfg_p, cfg_r, tree, params, ids, pos, lengths = tiny
    steps = 24
    with torch.no_grad():
        enc = nk.encoder_apply(params["encoder"], cfg_p.encoder, ids)
        fi = nk.fused_decode_inputs(params["decoder"], cfg_p.decoder, enc,
                                    pos, steps)
        mask = ref.padding_mask(lengths, TK)
        got = fd.fused_decode(params["decoder"], cfg_p.decoder, fi, mask,
                              torch.zeros(B, cfg_r.mel_dim), steps, 10,
                              early_exit=False, chunk=chunk)
        frames, probs, done, states, la = ref.decode(
            tree, cfg_r, *ref.encoder(tree, cfg_r, ids), pos, mask, steps)
    assert got.num_steps == steps
    _close(got.outputs, frames, 2e-5)
    _close(got.alignments, probs, 2e-5)
    _close(got.decoder_states, states, 2e-5)
    assert torch.equal(got.last_attended[:, 0].long(), la)


def _nyanko_hp():
    hp = json.loads((ROOT / "dv3bench" / "configs" /
                     "nyanko_ljspeech.json").read_text())
    hp.update(text_embed_dim=32, encoder_channels=32, decoder_channels=32,
              converter_channels=32, fft_size=256, hop_size=64)
    php = hparams.default_hparams()
    php.override_from_dict({k: v for k, v in hp.items() if k in php.values()})
    return hp, php


def test_tts_batch_features_match_the_reference():
    """tts_batch's mel and linear features (dB, denormalised) against the
    reference's encoder, free-running decode and converter on the same
    texts and weights."""
    torch.set_num_threads(1)
    hp, php = _nyanko_hp()
    cfg_p = model_builder.build_config(php, en.n_vocab)
    cfg_r = ref.config_from_hparams(hp, ref_text.N_VOCAB)
    tree = ref.seeded_tree(cfg_r, SEED, "cpu", done_bias=-30.0)
    texts = ["the cat sat, on a mat.", "a longer sentence of words here.",
             "short one."]
    steps = 20
    res = synthesis.tts_batch(ParamTree(tree), cfg_p, AudioProcessor(php),
                              en, texts, max_decoder_steps=steps,
                              early_exit=False)
    seqs = [ref_text.text_to_ids(t) for t in texts]
    tk = -(-max(map(len, seqs)) // 8) * 8
    ids = torch.zeros(len(texts), tk, dtype=torch.int64)
    pos = torch.zeros_like(ids)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = torch.tensor(s)
        pos[i, :len(s)] = torch.arange(1, len(s) + 1)
    lengths = torch.tensor([len(s) for s in seqs])
    with torch.no_grad():
        frames, _, _, states, _ = ref.decode(
            tree, cfg_r, *ref.encoder(tree, cfg_r, ids), pos,
            ref.padding_mask(lengths, tk), steps)
        linear = ref.converter(tree, cfg_r, states)
    floor = hp["min_level_db"]
    for i, r in enumerate(res):
        assert r["num_decoder_steps"] == steps
        assert r["alignment"].shape == (steps, len(seqs[i]))
        mel = (torch.from_numpy(r["mel"]) - floor) / -floor
        lin = (torch.from_numpy(r["linear"]) - floor) / -floor
        _close(mel, frames[i], 2e-5)
        _close(lin, linear[i], 2e-5)


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys\n"
            "import dv3bench.reference.nyanko, "
            "dv3bench.reference.nyanko_synthesis\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'deepvoice3_pytorch_tpu', "
            "'deepvoice3_pytorch_tpu_torch'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("builder_name,n_stages,counts", [
    ("nyanko", 25, {"LINEAR": 7, "HIGHWAY": 16, "ATTN": 1, "LINEAR2": 1}),
    ("deepvoice3", 11, {"LINEAR": 2, "GLU": 7, "ATTN": 2})])
def test_b1_stage_kinds(builder_name, n_stages, counts):
    """Each stage's kind is the first product of the op table it carries
    out (last_conv's stage, which carries none, counts as LINEAR)."""
    names = {fd.OP_LINEAR: "LINEAR", fd.OP_LINEAR2: "LINEAR2",
             fd.OP_GLU: "GLU", fd.OP_HIGHWAY: "HIGHWAY", fd.OP_ATTN: "ATTN"}
    kw = dict(TINY_NYANKO) if builder_name == "nyanko" else dict(
        TINY_NYANKO, embed_dim=32, use_decoder_state_for_postnet_input=True,
        key_projection=True, value_projection=True)
    cfg = getattr(builder, builder_name)(**kw)
    params = builder.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    plan = fd.build_plan(params["decoder"], cfg.decoder)
    stages, _ = fd.b1_stages(plan, fd.state_dim(cfg.decoder),
                             cfg.decoder.in_dim * cfg.decoder.r)
    kinds = fd.b1_stage_kinds(stages)
    assert len(kinds) == n_stages
    assert {k: kinds.count(k) for k in set(kinds)} == counts
    ops = plan.ops[:, 0].tolist()
    for st, kind in zip(stages, kinds):
        first = [names[ops[i]] for i in st.ops if ops[i] in names]
        assert kind == (first[0] if first else "LINEAR")


def _stamps(steps, n_stages, seed):
    """A launch's stamps: every stage's work and barrier wait drawn."""
    r = np.random.default_rng(seed)
    t = [1000, 1000 + int(r.integers(100, 500))]
    for _ in range(steps * n_stages):
        first = t[-1] + int(r.integers(1, 50))
        done = first + int(r.integers(0, 4000))
        t += [first, done, done + int(r.integers(0, 2000))]
    return np.array(t, np.int64)


def test_fold_b1_stamps_by_kind():
    steps, kinds = 3, ("LINEAR", "HIGHWAY", "ATTN", "HIGHWAY", "LINEAR")
    t = _stamps(steps, len(kinds), 1)
    whole = profiling.fold_b1_stamps(t, steps, len(kinds))
    parts = profiling.fold_b1_stamps_by_kind(t, steps, len(kinds), kinds)
    assert set(parts) == {"LINEAR", "HIGHWAY", "ATTN"}
    for k in ("work_ns", "barrier_ns"):
        assert sum(p[k] for p in parts.values()) == whole[k]
    # stage s of step j: work from the barrier before it, its wait after
    passed = np.concatenate([t[1:2], t[4::3]])
    hw = [s for j in range(steps) for s in (j * 5 + 1, j * 5 + 3)]
    assert parts["HIGHWAY"]["work_ns"] == int(sum(t[3 + 3 * s] - passed[s]
                                                  for s in hw))
    assert parts["HIGHWAY"]["barrier_ns"] == int(sum(
        t[4 + 3 * s] - t[3 + 3 * s] for s in hw))
    # work splits at the first stamp: products, then the epilogue
    assert parts["HIGHWAY"]["products_ns"] == int(sum(
        t[2 + 3 * s] - passed[s] for s in hw))
    for p in parts.values():
        assert p["products_ns"] + p["epilogue_ns"] == p["work_ns"]
        assert p["products_ns"] >= 0 and p["epilogue_ns"] >= 0
    assert profiling.fold_b1_stamps_by_kind(np.zeros(len(t)), steps,
                                            len(kinds), kinds) is None
    with pytest.raises(ValueError):
        profiling.fold_b1_stamps_by_kind(t, steps, len(kinds), kinds[:2])


def test_window_split_by_kind_keeps_the_totals():
    """A window's split by kind sums to its totals, and the totals are
    bit-equal to those of the same launches kept without kinds."""
    steps, kinds = 4, ("LINEAR", "HIGHWAY", "HIGHWAY", "ATTN")
    launches = [torch.from_numpy(_stamps(steps, len(kinds), s))
                for s in range(3)]
    plain, kinded = profiling.Window(), profiling.Window()
    for buf in launches:
        plain.stamps.append((buf, steps, len(kinds)))
        kinded.stamps.append((buf, steps, len(kinds), kinds))
    a, b = plain.b1_split(), kinded.b1_split()
    assert "kinds" not in a
    assert {k: v for k, v in b.items() if k != "kinds"} == a
    for k in ("work_ns", "barrier_ns"):
        assert sum(p[k] for p in b["kinds"].values()) == a[k]
    for p in b["kinds"].values():
        assert p["products_ns"] + p["epilogue_ns"] == p["work_ns"]
    # a launch kept without kinds leaves the split by kind out
    kinded.stamps.append((launches[0], steps, len(kinds), None))
    assert "kinds" not in kinded.b1_split()
