# coding: utf-8
"""Kernel B1's host side on the CPU: the stages the op table compiles to
(`fused_decode.b1_stages`), the per-block packing of the folded weights
and its shared-memory placement (`b1_layout`) at the three presets' full
widths, the packed-plan cache (`packed_plan`), the serving inputs' K/V
folded one row at a time at admission (`write_slot_row`), the plain
mirror of the monotonic-window shortcut (`window_attention_plain`,
below), and the whole stage program run on the CPU the way the kernel
runs it, against the plain decode.

Tolerances: ownership, packing, placement, the cache and the window
mirror are exact (the mirror sums the same nonzero terms in the same order
as the full attention, whose other terms are exact zeros; the layer's
output after the out-projection, whose matmul sums in its own order, to
1e-5). The stage program sums each product in another order than the
plain step's matmuls, so it is held as the card tests hold the kernel:
1e-4 of each output's scale, last_attended exact.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from deepvoice3_pytorch_tpu_torch import builder, hparams, model_builder
from deepvoice3_pytorch_tpu_torch.ops import attention as attn_ops
from deepvoice3_pytorch_tpu_torch.ops import core
from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMEM = 232448          # 227 KB: the dynamic shared memory of an H100 block
PRESETS = {"deepvoice3_ljspeech": 11, "nyanko_ljspeech": 25,
           "deepvoice3_vctk": 9}       # preset -> stages a step
_PRESET_CACHE = {}


def preset_decoder(preset):
    """(decoder config, decoder params) of a preset at full width, seeded
    random weights, on the CPU."""
    if preset not in _PRESET_CACHE:
        hp = hparams.default_hparams()
        with open(os.path.join(REPO, "presets", preset + ".json")) as f:
            hp.parse_json(f.read())
        cfg, params = model_builder.build_model(hp, 149, seed=3,
                                                device="cpu")
        _PRESET_CACHE[preset] = (cfg.decoder, params["decoder"])
    return _PRESET_CACHE[preset]


def unpack(lay, st):
    """The (K + 1, N) weight and bias of MV stage `st` rebuilt from the
    blocks' slices in lay.wpack, and how many slices hold each column."""
    w = st.words
    K, U, ncp = w[fd.S_K] + 1, w[fd.S_U], w[fd.S_NCP]
    N = 2 * U if w[fd.S_PAIRED] else U
    cols, _ = fd.stage_columns(U, w[fd.S_PAIRED], lay.grid, w[fd.S_ROT])
    out = torch.full((K, N), float("nan"))
    seen = np.zeros(N, np.int64)
    for j in range(lay.grid):
        sl = lay.wpack[j, w[fd.S_WOFF]:w[fd.S_WOFF] + K * ncp].view(K, ncp)
        for c, col in enumerate(cols[j]):
            if col >= 0:
                out[:, col] = sl[:, c]
                seen[col] += 1
            else:
                assert not bool(sl[:, c].any())      # padding is zero
    return out, seen


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_stages_cover_the_op_table(preset):
    """11 / 25 / 9 stages a step: every matrix-vector product of the op
    table, one ATT stage an attention layer (its query and out projections
    folded into the keys and values), and last_conv with fc folded in (16
    / 28 / 12 with the projections and fc on their own); every op of the
    table is carried out by exactly one stage. The stage before a conv
    writes its ring buffer, the one before an attention its query, the one
    before last_conv the decoder state."""
    dc, pd = preset_decoder(preset)
    plan = fd.build_plan(pd, dc)
    stages, widths = fd.b1_stages(plan, fd.state_dim(dc), dc.in_dim * dc.r)
    assert len(stages) == PRESETS[preset]
    kinds = plan.ops[:, 0].tolist()
    covered = [i for st in stages for i in st.ops]
    for i, k in enumerate(kinds):
        assert covered.count(i) == 1, (i, k)
    last = stages[-1].words
    assert last[fd.S_EPI] == fd.E_LAST and last[fd.S_U] == dc.in_dim * dc.r + 1
    assert [i for i, st in enumerate(stages) if st.words[fd.S_DSTATE]] == [
        len(stages) - 2]
    for i, st in enumerate(stages):
        if st.words[fd.S_RING] >= 0:
            assert stages[i - 1].words[fd.S_RINGW] == st.words[fd.S_RING]
    assert sorted(st.words[fd.S_RINGW] for st in stages
                  if st.words[fd.S_RINGW] >= 0) == list(range(
                      len(plan.buffers)))
    # each stage reads what an earlier one wrote (or the previous frame)
    made = {fd.IN_PREV, fd.BUF_FPE}
    for st in stages:
        w = st.words
        for src in (w[fd.S_IN], w[fd.S_IN2], w[fd.S_RES]):
            assert src == -1 or src in made, w
        if w[fd.S_OUT] >= 0:
            assert w[fd.S_OUT] not in made and \
                widths[w[fd.S_OUT]] == (w[fd.S_U] if w[fd.S_KIND] == fd.K_MV
                                        else fd.state_dim(dc))
            made.add(w[fd.S_OUT])
        if w[fd.S_QOUT] >= 0:           # x + the position rows
            assert widths[w[fd.S_QOUT]] == widths[w[fd.S_OUT]]
            made.add(w[fd.S_QOUT])


@pytest.mark.parametrize("grid", [132, 114, 8])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_column_owned_once_and_packing_unpacks(preset, grid):
    """At grids of 132, 114 and 8 blocks every output unit of every MV
    stage belongs to exactly one block, and the blocks' packed slices
    unpack bit-exactly to build_plan's folded weights and biases."""
    dc, pd = preset_decoder(preset)
    plan, lay = fd.packed_plan(pd, dc, grid, SMEM)
    for st in lay.stages:
        w = st.words
        if w[fd.S_KIND] != fd.K_MV:
            continue
        U = w[fd.S_U]
        owned = np.zeros(U, np.int64)
        for j in range(grid):
            u0, u1 = fd.block_units(U, grid, w[fd.S_ROT], j)
            owned[u0:u1] += 1
        assert (owned == 1).all(), w
        W, seen = unpack(lay, st)
        assert (seen == 1).all()
        weight, bias = fd.stage_weight(plan, st)
        assert torch.equal(W[:-1], weight) and torch.equal(W[-1], bias)
        if w[fd.S_EPI] == fd.E_LAST:
            # last_conv's own columns are build_plan's; fc's is folded in
            lw = plan.weights[plan.last[0]:plan.last[0] + weight[:, :-1]
                              .numel()].view(weight.shape[0], -1)
            assert torch.equal(weight[:, :-1], lw)
        elif len(st.w_offs) == 1:
            o = st.w_offs[0]
            assert torch.equal(weight.reshape(-1),
                               plan.weights[o:o + weight.numel()])


@pytest.mark.parametrize("grid", [132, 114, 8])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_shared_memory_within_a_block(preset, grid):
    """Each block's shared memory stays within 227 KB; the slices that do
    not fit are planned to device memory (L2), read each step. On one block
    an SM every preset's weights stay on chip (nyanko's 211.6 KB a block
    too); on 114 blocks nyanko's overflow, on 8 every preset's."""
    dc, pd = preset_decoder(preset)
    plan, lay = fd.packed_plan(pd, dc, grid, SMEM)
    assert lay.smem_bytes <= SMEM
    assert lay.smem_bytes == 4 * fd.b1_smem_floats(lay.meta, lay.resident,
                                                   lay.max_ncp)
    assert lay.meta == fd.b1_meta_ints(len(lay.stages), len(lay.widths),
                                       len(plan.buffers))
    mv = [st for st in lay.stages if st.words[fd.S_KIND] == fd.K_MV]
    sizes = [fd._round4((st.words[fd.S_K] + 1) * st.words[fd.S_NCP])
             for st in mv]
    on_chip = sum(s for st, s in zip(mv, sizes) if st.words[fd.S_RESIDENT])
    assert on_chip == lay.resident and sum(sizes) == lay.per_block
    # resident slices first in a block's row, in stage order, then the rest
    offs = [st.words[fd.S_WOFF] for st in mv if st.words[fd.S_RESIDENT]]
    assert offs == sorted(offs) and (not offs or offs[0] == 0)
    assert all(st.words[fd.S_WOFF] >= lay.resident for st in mv
               if not st.words[fd.S_RESIDENT])
    spills = lay.resident < lay.per_block
    assert spills == (grid == 8 or (grid == 114 and preset
                                    == "nyanko_ljspeech")), json.dumps(
        [lay.resident, lay.per_block])
    total = sum(st.words[fd.S_K] * (2 if st.words[fd.S_PAIRED] else 1)
                * st.words[fd.S_U] for st in mv)
    assert total == sum(fd.stage_weight(plan, st)[0].numel() for st in mv)


def test_budget_below_the_fixed_part_raises():
    dc, pd = preset_decoder("deepvoice3_vctk")
    plan = fd.build_plan(pd, dc)
    lay = fd.b1_layout(plan, 256, 80, 132)
    fixed = 4 * fd.b1_smem_floats(lay.meta, 0, lay.max_ncp)
    lay = fd.b1_layout(plan, 256, 80, 132, fixed)
    assert lay.resident == 0 and lay.smem_bytes == fixed
    with pytest.raises(ValueError):
        fd.b1_layout(plan, 256, 80, 132, fixed - 4)


def test_packed_plan_cache_follows_the_tensors():
    """The same parameter tensors give the same packing (no rebuild); an
    in-place update of any weight rebuilds it, with the new weights."""
    cfg = builder.deepvoice3(**TINY)
    params = builder.model_init(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    pd = params["decoder"]
    first = fd.packed_plan(pd, cfg.decoder, 7)
    assert fd.packed_plan(pd, cfg.decoder, 7) is first
    assert fd.packed_plan(pd, cfg.decoder, 5) is not first
    with torch.no_grad():
        pd["last_conv"]["b"].add_(1.0)
    second = fd.packed_plan(pd, cfg.decoder, 7)
    assert second is not first
    assert not torch.equal(second[0].weights, first[0].weights)
    assert torch.equal(second[0].weights,
                       fd.build_plan(pd, cfg.decoder).weights)
    assert fd.packed_plan(pd, cfg.decoder, 7) is second


# ---------------------------------------------------------------------------
# the monotonic-window shortcut
# ---------------------------------------------------------------------------


def window_attention_plain(qp, keys, values, mask, last_attended, back,
                           ahead, ctx_scale, key_bias=None):
    """Plain mirror of the kernel's monotonic-window shortcut for one
    attention layer: for each row whose window [la - back, la + ahead)
    holds an unpadded key, the softmax, the first argmax and the context
    over the window's keys alone; other rows take every key, as the plain
    attention does. qp (B, E) projected queries, keys / values (B, Tk, E),
    mask (B, Tk) True where padded, last_attended (B,), ctx_scale (B,);
    key_bias (B, Tk) or None, added to the scores (the kernel's folded
    query-projection bias).
    The context sums key by key in index order, as the kernel does.
    Returns (context * scale (B, E), attention (B, Tk), new
    last_attended)."""
    B, Tk = keys.shape[:2]
    scores = torch.einsum("be,bke->bk", qp.float(), keys.float())
    if key_bias is not None:
        scores = scores + key_bias
    scores = scores.masked_fill(mask, fd.MASK)
    idx = torch.arange(Tk, device=keys.device)
    attn = torch.zeros_like(scores)
    ctx = qp.new_zeros(B, values.shape[-1])
    la = last_attended.clone()
    for b in range(B):
        lo = max(0, int(last_attended[b]) - back)
        hi = min(Tk, int(last_attended[b]) + ahead)
        if not (hi > lo and not bool(mask[b, lo:hi].all())):
            lo, hi = 0, Tk
            scores[b] = scores[b].masked_fill(
                (idx < last_attended[b] - back)
                | (idx >= last_attended[b] + ahead), fd.MASK)
        p = torch.softmax(scores[b, lo:hi], -1)
        attn[b, lo:hi] = p
        for k in range(hi - lo):
            ctx[b] = ctx[b] + p[k] * values[b, lo + k]
        la[b] = lo + int(torch.argmax(p))
    return ctx * ctx_scale[:, None], attn, la


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_shortcut_equals_full_attention(seed):
    """Rows whose window sits at the text's start, in its middle, at its
    end, over padded keys, and with no unpadded key at all (the shortcut
    falls back to every key): the attention and last_attended equal the
    plain attention's bit for bit, and so does the context summed over
    every key in the kernel's order (key by key)."""
    g = torch.Generator().manual_seed(seed)
    B, Tk, E, C = 7, 13, 16, 24
    spec = attn_ops.AttentionSpec(conv_channels=C, embed_dim=E,
                                  window_backward=1, window_ahead=3)
    p = attn_ops.attention_init(g, spec)
    query = torch.randn(B, C, generator=g)
    keys = torch.randn(B, Tk, E, generator=g)
    values = torch.randn(B, Tk, E, generator=g)
    lengths = torch.tensor([13, 13, 13, 9, 9, 6, 4])
    mask = core.get_mask_from_lengths(lengths, Tk)
    # window at 0, middle, end, end of a padded row, across its padding,
    # wholly in padding (no unpadded key), and at the row's last key
    la = torch.tensor([0, 6, 12, 8, 9, 10, 3])
    scale = torch.full((B,), Tk * math.sqrt(1.0 / Tk))
    out, attn = attn_ops.attention_step(p, spec, query, keys, values,
                                        mask=mask, last_attended=la)
    qp = core.linear_apply(p["query_proj"], query)
    ctx, attn_w, la_w = window_attention_plain(
        qp, keys, values, mask, la, spec.window_backward, spec.window_ahead,
        scale)
    assert torch.equal(attn_w, attn)
    assert torch.equal(la_w, torch.argmax(attn, -1))
    # the context over every key, summed key by key as the kernel does:
    # the keys outside the window add exact zeros
    x = torch.zeros(B, E)
    for k in range(Tk):
        x = x + attn[:, k:k + 1] * values[:, k]
    assert torch.equal(ctx, x * scale[:, None])
    # and the layer's output, with the plain attention's matmul order
    got = (core.linear_apply(p["out_proj"], ctx) + query) * math.sqrt(0.5)
    assert float((got - out).abs().max()) <= 1e-5
    # the fallback row: no unpadded key in [la - 1, la + 3)
    assert bool(mask[5, 9:13].all())


# ---------------------------------------------------------------------------
# the stage program on the CPU, as the kernel runs it
# ---------------------------------------------------------------------------

TINY = dict(n_vocab=149, embed_dim=32, mel_dim=16, linear_dim=65, r=1,
            downsample_step=4, kernel_size=3, encoder_channels=32,
            decoder_channels=32, converter_channels=32, use_memory_mask=True,
            key_projection=True, value_projection=True, max_positions=64,
            force_monotonic_attention=True)


def tiny_decoder(name, B=3, Tk=12, seed=0):
    kw = dict(TINY)
    if name == "nyanko":
        kw.pop("key_projection")
        kw.pop("value_projection")
    if name == "deepvoice3_multispeaker":
        kw.update(n_speakers=5, speaker_embed_dim=8, query_position_rate=2.0,
                  key_position_rate=7.6)
    cfg = getattr(builder, name)(**kw)
    params = builder.model_init(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    enc = tuple(torch.randn(B, Tk, 32, generator=g) * 0.5 for _ in range(2))
    lengths = torch.tensor([Tk, Tk // 2 + 1, Tk - 3][:B])
    pos = torch.arange(1, Tk + 1)[None].repeat(B, 1)
    pos = torch.where(pos <= lengths[:, None], pos, torch.zeros_like(pos))
    se = None
    if cfg.n_speakers > 1:
        se = builder.embed_speakers(params, cfg, torch.arange(B) % 5)
    fi = cfg.family.fused_decode_inputs(params["decoder"], cfg.decoder, enc,
                                        pos, speaker_embed=se)
    return cfg.decoder, params["decoder"], fi, \
        core.get_mask_from_lengths(lengths, Tk)


def run_stages(plan, lay, fi, mask, init, steps):
    """One launch of the stage program from a zero carry, stage by stage
    and block by block as csrc/fused_decode.cu runs it (rings of rows + 1
    slots written by the stage before their conv, fc folded into
    last_conv, the attention's projections folded into its keys and
    values); returns the (outputs, alignments, done, decoder_states) and
    last_attended."""
    S = np.sqrt(0.5).astype(np.float32).item()
    kv = [p for p in fi["projected_kv"] if p is not None]
    B, Tk, E = kv[0][0].shape
    kvf = fd.attention_operands(lay.att_w, torch.stack(
        [torch.stack([k, v]) for k, v in kv]))
    C, out_dim = lay.widths[fd.BUF_FPE], lay.widths[fd.BUF_PREV0]
    n_la = max(plan.n_att, 1)
    bufs = [torch.zeros(B, w) for w in lay.widths]
    bufs[fd.BUF_PREV0] = init.clone()
    rings = lay.rings.tolist()
    scratch = torch.zeros(B, sum((r + 1) * c for r, c, _ in plan.buffers))
    la = torch.zeros(B, n_la, dtype=torch.int64)
    ave = torch.zeros(B, Tk)
    outs = (torch.zeros(B, steps, out_dim), torch.zeros(B, steps, Tk),
            torch.zeros(B, steps), torch.zeros(B, steps, C))
    sp = fi.get("speaker_bias") or []
    scale = torch.full((B,), Tk * math.sqrt(1.0 / Tk))

    def buf(i, step):
        return bufs[step & 1 if i == fd.IN_PREV else i]

    def slot(ring, i):
        rows, cin, _, off = rings[ring]
        return slice(off + i * cin, off + (i + 1) * cin)

    def products(w, step):
        """[taps | x] (or [x, Q]) @ W + b of an MV stage, over the blocks'
        column slices; and its x."""
        segs = []
        if w[fd.S_RING] >= 0:
            rows = rings[w[fd.S_RING]][0]
            for j in range(w[fd.S_KW] - 1):
                i = (step % (rows + 1) + j * w[fd.S_DIL]) % (rows + 1)
                segs.append(scratch[:, slot(w[fd.S_RING], i)])
        x = buf(w[fd.S_IN], step)
        segs.append(x)
        if w[fd.S_IN2] >= 0:
            segs.append(buf(w[fd.S_IN2], step))
        X = torch.cat(segs, 1)
        U, K = w[fd.S_U], w[fd.S_K]
        y = torch.zeros(B, 2 * U if w[fd.S_PAIRED] else U)
        for j in range(lay.grid):
            u0, u1 = fd.block_units(U, lay.grid, w[fd.S_ROT], j)
            nu, ncp = u1 - u0, w[fd.S_NCP]
            sl = lay.wpack[j, w[fd.S_WOFF]:w[fd.S_WOFF]
                           + (K + 1) * ncp].view(K + 1, ncp)
            yj = X @ sl[:K] + sl[K]              # the slice's biases
            y[:, u0:u1] = yj[:, :nu]
            if w[fd.S_PAIRED]:
                y[:, U + u0:U + u1] = yj[:, nu:2 * nu]
        return y, x

    for step in range(steps):
        raw = fi["fpe_table"][step]
        bufs[fd.BUF_FPE] = (torch.where(
            torch.arange(C) % 2 == 1, torch.cos(fi["w_query"][:, None] * raw),
            torch.sin(fi["w_query"][:, None] * raw))
            if fi["fpe_raw"] else raw[None].expand(B, C).clone())
        for st in lay.stages:
            w = st.words
            epi, flag, U = w[fd.S_EPI], w[fd.S_FLAG], w[fd.S_U]
            if w[fd.S_KIND] == fd.K_ATT:
                a = w[fd.S_AIDX]
                q = buf(w[fd.S_IN], step)
                o, p, new_la = window_attention_plain(
                    q, kvf[a, 0, ..., :C], kvf[a, 1, ..., :C], mask,
                    la[:, a], w[fd.S_BACK], w[fd.S_AHEAD], scale,
                    key_bias=kvf[a, 0, ..., C])
                if w[fd.S_MONO]:
                    la[:, a] = new_la
                ave = p if a == 0 else ave + p
                if a == plan.n_att - 1:
                    outs[1][:, step] = ave / n_la
                v = (o + plan.weights[w[fd.S_BIAS]:w[fd.S_BIAS] + C] + q) * S
            else:
                y, x = products(w, step)
                if epi == fd.E_LAST:
                    outs[0][:, step] = bufs[(step + 1) & 1] = \
                        torch.sigmoid(y[:, :out_dim])
                    outs[2][:, step] = torch.sigmoid(y[:, out_dim])
                    continue
                if epi == fd.E_LIN:
                    v = (torch.relu(y) if flag == 1 else torch.sigmoid(y)
                         if flag == 2 else y)
                elif epi == fd.E_GLU:
                    val = y[:, :U]
                    if w[fd.S_SLOT] >= 0 and sp:
                        val = val + sp[w[fd.S_SLOT]]
                    v = val * torch.sigmoid(y[:, U:])
                    if flag:
                        v = (v + x) * S
                else:                             # E_HW
                    g = torch.sigmoid(y[:, U:])
                    v = ((y[:, :U] * g + x) * S if flag
                         else g * y[:, :U] + (1 - g) * x)
            if w[fd.S_RES] >= 0:
                v = (v + buf(w[fd.S_RES], step)) * S
            bufs[w[fd.S_OUT]] = v
            if w[fd.S_QOUT] >= 0:
                bufs[w[fd.S_QOUT]] = v + bufs[fd.BUF_FPE]
            if w[fd.S_RINGW] >= 0:
                rows = rings[w[fd.S_RINGW]][0]
                scratch[:, slot(w[fd.S_RINGW], (step + rows) % (rows + 1))] \
                    = v
            if w[fd.S_DSTATE]:
                outs[3][:, step] = v
    return outs, la[:, :plan.n_att]


@pytest.mark.parametrize("name,grid", [("deepvoice3", 5), ("deepvoice3", 64),
                                       ("nyanko", 7),
                                       ("deepvoice3_multispeaker", 3)])
def test_stage_program_matches_plain_decode(name, grid):
    """The stage program of a tiny decoder of each family (every op kind,
    ring buffers, speaker biases, encoded positions, the monotonic window
    with padded rows), blocks owning uneven column slices, against the
    plain decode over 10 steps."""
    stage_program_against_plain(name, grid, 10)


def stage_program_against_plain(name, grid, steps):
    """run_stages of a tiny decoder of family `name` on `grid` blocks
    against the plain decode, both one chunk of `steps` frames (whole
    chunks of 32 would run the plain carry on past `steps`)."""
    dc, pd, fi, mask = tiny_decoder(name)
    plan, lay = fd.packed_plan(pd, dc, grid, SMEM)
    assert fi["fpe_table"].shape[0] >= steps
    init = torch.zeros(3, dc.in_dim * dc.r)
    got, la = run_stages(plan, lay, fi, mask, init, steps)
    want = fd.fused_decode_plain(pd, dc, fi, mask, init, steps, 2,
                                 early_exit=False, chunk=steps)
    for a, b in zip(got, want[:4]):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max()))
    assert torch.equal(la, want.last_attended.long())
    return plan


@pytest.mark.parametrize("name,grid", [("nyanko", 7), ("deepvoice3", 5),
                                       ("deepvoice3_multispeaker", 3)])
def test_stage_program_matches_plain_decode_across_the_ring_wrap(name, grid):
    """The stage program over 60 steps, more than the longest ring has
    slots (a dilation-27 conv keeps 54 past frames in 55 slots), so every
    slot is written and its taps read again after the ring wraps: still
    the plain decode's frames, run as one chunk of 60 steps."""
    plan = stage_program_against_plain(name, grid, 60)
    assert max(r for r, _, _ in plan.buffers) + 1 == 55


@pytest.mark.parametrize("name", ["deepvoice3", "nyanko",
                                  "deepvoice3_multispeaker"])
def test_slot_inputs_fold_each_admitted_row(name):
    """Serving's inputs keep the K/V folded with the decoder's attention
    projections: an admission folds its own row (equal bit for bit to
    folding that row alone, and to the whole batch's fold within f32
    rounding), zero past its text; a growth pads the fold with zeros; the
    plain decoder's inputs keep no fold."""
    dc, pd, fi, mask = tiny_decoder(name, B=3, Tk=12)
    att_w = fd.packed_plan(pd, dc, 5, SMEM)[1].att_w
    lengths = (~mask).sum(1)

    def row(b):
        one = slice(b, b + 1)
        return dict(fi, projected_kv=[
            None if p is None else (p[0][one, :int(lengths[b])],
                                    p[1][one, :int(lengths[b])])
            for p in fi["projected_kv"]],
            w_query=None if fi["w_query"] is None else fi["w_query"][one],
            speaker_bias=[x[one] for x in fi["speaker_bias"] or []],
            speaker_embed=(None if fi.get("speaker_embed") is None
                           else fi["speaker_embed"][one]))

    assert fd.slot_inputs(row(0), 4, 16).kvf is None
    si = fd.slot_inputs(row(0), 4, 16, att_w)
    for b in (2, 0, 1):
        n = int(lengths[b])
        fd.write_slot_row(si, b, row(b), mask[b:b + 1, :n], 1.0)
    assert si.kvf.shape == si.kv.shape[:4] + (fd.state_dim(dc) + 1,)
    for b in range(3):
        n = int(lengths[b])
        assert torch.equal(si.kvf[:, :, b:b + 1, :n], fd.attention_operands(
            att_w, si.kv[:, :, b:b + 1, :n].contiguous()))
        assert not si.kvf[:, :, b, n:].any()
    assert not si.kvf[:, :, 3].any()
    whole = fd.attention_operands(att_w, si.kv)
    assert float((whole - si.kvf).abs().max()) <= 1e-5 * float(
        whole.abs().max())
    grown = fd.grow_slot_inputs(si, 20)
    assert torch.equal(grown.kvf[:, :, :, :16], si.kvf)
    assert not grown.kvf[:, :, :, 16:].any()
    assert grown.att_w is att_w
