# coding: utf-8
"""The port's device mesh (deepvoice3_pytorch_tpu_torch/parallel/mesh.py)
against the one-process port and the JAX package's mesh runs, on the CPU.

The port's ranks are processes of their own (tests/torch_mesh_ranks.py,
which imports no JAX) in a gloo group initialised through a file under
tmp_path; three sessions run every rank body once: dp (mesh 2 x 1), tp
(1 x 2) and dp x tp (2 x 2, four processes). The JAX side runs in this
process on the 8 virtual CPU devices of tests/conftest.py. Dropout is 0, as
in tests/test_multichip.py.

Bars:
  * dp = 2 and dp x tp train steps against the one-process port: 2e-6 on
    every parameter and 1e-6 relative on the loss (tests/test_multichip.py's);
    against JAX's mesh runs (dp = 4; 4 x 2 with tp): 5e-5 on the parameters
    and 1e-5 relative on the loss (tests/test_torch_training.py's step);
  * the tp = 2 forward against the replicated forward and JAX's tp forward:
    1e-5 of the output's scale;
  * grad_norm under tp, with the clip engaged: 1e-5 relative;
  * the checkpoint round trip under dp x tp: bit for bit;
  * tts_batch(mesh=) against the one-process call and against JAX's
    tts_batch(mesh=make_mesh(4, 1), fused=True): mel / linear / alignment
    3e-4, waveform 5e-2, decoded steps equal
    (test_dp_fused_synthesis_matches_single_device's); the waveform against
    JAX's, whose Griffin-Lim rounds in another bf16 schedule, at
    tests/test_torch_synthesis.py's 0.12 of the peak.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu import builder as jb
from deepvoice3_pytorch_tpu.ops import core as j_core
from deepvoice3_pytorch_tpu.parallel import mesh as j_mesh
from deepvoice3_pytorch_tpu.training import checkpoint as j_ckpt
from deepvoice3_pytorch_tpu.training import trainer as jt
from deepvoice3_pytorch_tpu_torch import builder as tb
from deepvoice3_pytorch_tpu_torch.params import (flatten_tree, model_init,
                                                 param_shapes)
from deepvoice3_pytorch_tpu_torch.parallel import mesh as t_mesh

import torch_mesh_ranks as ranks
from torch_port_common import (TINY, TINY_MULTISPEAKER, TINY_NYANKO,
                               maxdiff, text_inputs)

CLIP = 0.02           # below the tiny model's gradient norm: the clip acts
TINY0 = dict(TINY, dropout=0.0)
TEXTS = ["hello world.", "a longer test sentence here.", "ok."]
TTS_HP = "fft_size=256,hop_size=64,griffin_lim_iters=4"
TTS_KW = dict(p=0.0, max_decoder_steps=12, early_exit=True)


def _params_np(cfg_kw, seed=0):
    return flatten_tree(jax.tree_util.tree_map(
        np.asarray, jb.model_init(jax.random.PRNGKey(seed),
                                  jb.deepvoice3(**cfg_kw))))


def _fwd_batch():
    x, pos, lengths = text_inputs()
    B, T_dec = x.shape[0], 10
    mel = np.random.RandomState(5).rand(B, T_dec, 16).astype(np.float32)
    fpos = np.tile(np.arange(1, T_dec + 1), (B, 1)).astype(np.int32)
    return dict(x=x, mel=mel, text_positions=pos, frame_positions=fpos,
                input_lengths=lengths)


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return {
        "builder": "deepvoice3", "cfg": ranks.CFG,
        "params": _params_np(ranks.CFG), "hp": ranks.HP,
        "clip_hp": dict(ranks.HP, clip_thresh=CLIP),
        "batches": [ranks.batch(seed=i) for i in range(5)],
        "ragged": [ranks.batch(ragged=True)],
        "fwd_cfg": TINY0, "fwd_params": _params_np(TINY0, seed=42),
        "fwd_batch": _fwd_batch(),
        "tts_cfg": ranks.CFG, "tts_params": _params_np(ranks.CFG),
        "tts_hparams": TTS_HP,
        "texts": TEXTS, "tts_kw": TTS_KW,
        "ckpt_dir": str(tmp_path_factory.mktemp("mesh_ckpt")),
        "builders": {
            "nyanko": _port_builder("nyanko", TINY_NYANKO, {}),
            "deepvoice3_multispeaker": _port_builder(
                "deepvoice3_multispeaker", TINY_MULTISPEAKER,
                {"speaker_ids": np.asarray([0, 2, 4])})},
        "speaker_ids": [0, 3, 4],
        "speaker_tts_hparams": "fft_size=128,hop_size=32,num_mels=16,"
                               "griffin_lim_iters=4",
    }


def _port_builder(name, cfg_kw, extra):
    """The other two builders at the tiny widths, seeded port parameters
    (their parity with JAX is tests/test_torch_nyanko.py's and
    tests/test_torch_multispeaker.py's)."""
    cfg_kw = dict(cfg_kw, dropout=0.0)
    params = model_init(getattr(tb, name)(**cfg_kw),
                        torch.Generator().manual_seed(5), "cpu")
    return {"cfg": cfg_kw, "extra": extra,
            "params": {k: v.numpy() for k, v in params.state_dict().items()}}


@pytest.fixture(scope="module")
def dp_ranks(spec, tmp_path_factory):
    return ranks.spawn("dp", spec, tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def tp_ranks(spec, tmp_path_factory):
    return ranks.spawn("tp", spec, tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def dptp_ranks(spec, tmp_path_factory):
    return ranks.spawn("dptp", spec, tmp_path_factory.mktemp("dptp"))


@pytest.fixture(scope="module")
def one_process(spec):
    """The rank bodies in this process, without a mesh."""
    cpu = torch.device("cpu")
    return {name: getattr(ranks, "body_" + name)(spec, None, cpu)
            for name in ("dp_train", "ragged", "dptp_step", "clip",
                         "tp_forward", "tp_builders", "tts", "tts_speakers")}


# ---------------------------------------------------------------------------
# the mesh, the rows, the tp leaf set: no process group needed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,n_data,n_model", [
    (8, None, 1), (8, None, 2), (8, 4, 2), (8, 2, 2), (6, None, 4),
    (1, None, 1), (1, None, 2), (4, 4, 2), (8, 0, 8), (2, 3, 1)])
def test_mesh_shape_matches_jax(world, n_data, n_model):
    devices = jax.devices()[:world]
    try:
        want = j_mesh.make_mesh(n_data, n_model, devices=devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_mesh.mesh_shape(world, n_data, n_model)
        assert str(got.value) == str(e)
        return
    assert t_mesh.mesh_shape(world, n_data, n_model) == (
        want.shape["data"], want.shape["model"])


def test_make_mesh_without_a_group_is_a_world_of_one():
    import torch.distributed as dist

    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        t_mesh.make_mesh(n_model=2, device="cpu")
    assert not dist.is_initialized()
    try:
        mesh = t_mesh.make_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert t_mesh.is_main(mesh)
        t = torch.arange(4.0)
        assert torch.equal(t_mesh.all_reduce(
            t.clone(), t_mesh.axis_group(mesh, "data")), t)
    finally:
        dist.destroy_process_group()


class _Coordinate:
    """The DeviceMesh surface shard_batch reads, at one data rank of a
    (n_data, 1) mesh."""
    mesh_dim_names = ("data", "model")

    def __init__(self, n_data, rank):
        self.shape, self.rank = (n_data, 1), rank

    def get_local_rank(self, axis):
        return self.rank if axis == "data" else 0


def test_shard_batch_matches_jax_addressable_shards():
    mesh = j_mesh.make_mesh(n_data=4, n_model=1)
    b = ranks.batch()
    placed = j_mesh.shard_batch(mesh, b)
    got = [t_mesh.shard_batch(_Coordinate(4, r), b) for r in range(4)]
    for k in b:
        shards = sorted(placed[k].addressable_shards,
                        key=lambda s: s.index[0].start)
        assert len(shards) == 4
        for r, s in enumerate(shards):
            assert np.array_equal(got[r][k], np.asarray(s.data)), k
    with pytest.raises(ValueError, match="does not divide"):
        t_mesh.shard_batch(_Coordinate(4, 0), ranks.batch(B=6))


def test_tp_leaf_set_matches_jax_param_shardings():
    """The port slices exactly the `v` leaves that JAX's rule shards, less
    the transposed convs, and each such layer's `g` and `b` with them."""
    cfg_j, cfg_t = jb.deepvoice3(**TINY), tb.deepvoice3(**TINY)
    mesh = j_mesh.make_mesh(n_data=4, n_model=2)
    pj = jb.model_init(jax.random.PRNGKey(0), cfg_j)
    specs = flatten_tree(jax.tree_util.tree_map(
        lambda s: s.spec, j_mesh.param_shardings(pj, mesh, tp=True),
        is_leaf=lambda s: hasattr(s, "spec")))
    jax_v = {k for k, s in specs.items() if "model" in str(s)}
    shapes = {k: tuple(v.shape) for k, v in param_shapes(cfg_t).items()}
    convT = t_mesh.convT_layers(cfg_t)
    axes = t_mesh.tp_axes(shapes, 2, convT)
    assert len(convT) == 2 and {p + ".v" for p in convT} <= jax_v
    port_v = {k for k in axes if k.endswith(".v")}
    assert port_v == jax_v - {p + ".v" for p in convT}
    assert set(axes) == port_v | {k[:-1] + s for k in port_v
                                  for s in ("g", "b")}
    for k, a in axes.items():
        assert a == (len(shapes[k]) - 1 if k.endswith(".v") else 0)


def test_dropout_seed_keeps_one_process_numbers():
    base = 1234 * 1000003 + 7
    assert t_mesh.dropout_seed(base, None) == base
    assert t_mesh.dropout_seed(base, _Coordinate(4, 0)) == base
    assert len({t_mesh.dropout_seed(base, _Coordinate(4, d))
                for d in range(4)}) == 4


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


class _HP:
    pass


def _jax_hp():
    hp = _HP()
    hp.__dict__.update(ranks.HP)
    return hp


@functools.lru_cache(maxsize=1)
def _jax_step():
    """JAX's jitted train step, built once (its compilations are cached per
    mesh)."""
    hp = _jax_hp()
    cfg = jb.deepvoice3(**ranks.CFG)
    params = jb.model_init(jax.random.PRNGKey(0), cfg)
    opt = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    return params, opt, jt.make_train_step(
        cfg, jt.loss_config_from_hparams(hp), opt,
        jt.trainable_mask(params, cfg))


def _jax_run(batches, n_data, n_model=1, tp=False):
    """JAX's train step on a mesh from the same initial parameters:
    (parameters after the batches, losses)."""
    params, opt, step_fn = _jax_step()
    mesh = j_mesh.make_mesh(n_data=n_data, n_model=n_model)
    state = jt.init_train_state(j_mesh.shard_params(
        jax.tree.map(jnp.array, params), mesh, tp=tp), opt)
    losses = []
    for i, b in enumerate(batches):
        state, m = step_fn(state, j_mesh.shard_batch(mesh, b),
                           jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    return flatten_tree(jax.tree_util.tree_map(np.asarray, state.params)), \
        losses


def _close(got, want, atol, what):
    assert got.keys() == want.keys()
    worst = max(maxdiff(got[k], want[k]) for k in want)
    assert worst <= atol, (what, worst)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_dp2_train_matches_one_process_and_jax(dp_ranks, one_process, spec):
    got, want = dp_ranks[0]["dp_train"], one_process["dp_train"]
    _close(got["params"], want["params"], 2e-6, "dp=2 vs one process")
    for g, w in zip(got["metrics"], want["metrics"]):
        assert _rel(g["loss"], w["loss"]) <= 1e-6
        assert _rel(g["grad_norm"], w["grad_norm"]) <= 1e-5
    jp, jl = _jax_run(spec["batches"][:3], 4)
    _close(got["params"], jp, 5e-5, "dp=2 vs JAX dp=4")
    for g, w in zip(got["metrics"], jl):
        assert _rel(g["loss"], w) <= 1e-5


def test_dp2_params_identical_across_ranks(dp_ranks):
    a = dp_ranks[0]["dp_train"]["params"]
    b = dp_ranks[1]["dp_train"]["params"]
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_dp2_ragged_shards_use_global_denominators(dp_ranks, one_process,
                                                   spec):
    """The two shards' masks hold 15 and 7 valid frames: each masked term
    must divide by the global count. The mean of the two halves' own losses
    (per-shard means) misses the global loss by far more than the bar."""
    got, want = dp_ranks[0]["ragged"], one_process["ragged"]
    assert _rel(got["metrics"][0]["loss"], want["metrics"][0]["loss"]) \
        <= 1e-6
    _close(got["params"], want["params"], 2e-6, "ragged dp=2")
    jp, jl = _jax_run(spec["ragged"], 4)
    assert _rel(got["metrics"][0]["loss"], jl[0]) <= 1e-5
    _close(got["params"], jp, 5e-5, "ragged dp=2 vs JAX dp=4")
    halves = []
    for rows in (slice(0, 4), slice(4, 8)):
        half = {k: v[rows] for k, v in spec["ragged"][0].items()}
        _, m = ranks.train(spec, None, torch.device("cpu"), [half])
        halves.append(m[0]["loss"])
    assert _rel(np.mean(halves), want["metrics"][0]["loss"]) > 1e-3


def test_dp_tp_step_matches_one_process_and_jax(dptp_ranks, one_process):
    got, want = dptp_ranks[0]["dptp_step"], one_process["dptp_step"]
    _close(got["params"], want["params"], 2e-6, "dp=2 x tp=2 step")
    assert _rel(got["metrics"][0]["loss"], want["metrics"][0]["loss"]) \
        <= 1e-6
    assert _rel(got["metrics"][0]["grad_norm"],
                want["metrics"][0]["grad_norm"]) <= 1e-5
    for r in dptp_ranks[1:]:
        assert all(np.array_equal(r["dptp_step"]["params"][k],
                                  got["params"][k]) for k in got["params"])
    jp, jl = _jax_run([ranks.batch(seed=0)], 4, 2, tp=True)
    _close(got["params"], jp, 5e-5, "dp=2 x tp=2 vs JAX 4 x 2")
    assert _rel(got["metrics"][0]["loss"], jl[0]) <= 1e-5


def test_tp2_clip_engages_with_one_process_grad_norm(tp_ranks, one_process):
    got, want = tp_ranks[0]["clip"], one_process["clip"]
    for g, w in zip(got["metrics"], want["metrics"]):
        assert w["grad_norm"] > CLIP
        assert _rel(g["grad_norm"], w["grad_norm"]) <= 1e-5
    _close(got["params"], want["params"], 2e-6, "tp=2 clipped steps")


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


def test_tp2_forward_matches_replicated_and_jax(tp_ranks, one_process, spec):
    cfg_j = jb.deepvoice3(**TINY0)
    pj = jb.model_init(jax.random.PRNGKey(42), cfg_j)
    b = spec["fwd_batch"]
    mesh = j_mesh.make_mesh(n_data=4, n_model=2)

    def fwd(p):
        return jb.model_forward(
            p, cfg_j, jnp.asarray(b["x"]), jnp.asarray(b["mel"]),
            text_positions=jnp.asarray(b["text_positions"]),
            frame_positions=jnp.asarray(b["frame_positions"]),
            input_lengths=jnp.asarray(b["input_lengths"]), training=False)

    with j_core.strict_numerics():
        want_j = jax.jit(fwd)(j_mesh.shard_params(pj, mesh, tp=True))
    want = one_process["tp_forward"]["outputs"]
    for r in tp_ranks:
        got = r["tp_forward"]
        assert got["sharded"]
        assert any(got["local_shapes"][k] != tuple(np.shape(spec[
            "fwd_params"][k])) for k in got["sharded"])
        for g, w, wj in zip(got["outputs"], want, want_j):
            scale = max(1.0, float(np.abs(np.asarray(wj)).max()))
            assert maxdiff(g, w) <= 1e-5 * scale
            assert maxdiff(g, np.asarray(wj)) <= 1e-5 * scale


@pytest.mark.parametrize("name", ["nyanko", "deepvoice3_multispeaker"])
def test_tp2_forward_of_the_other_builders_matches_replicated(
        tp_ranks, one_process, name):
    """nyanko (highway stacks, the key / value chunk after a conv, two
    transposed convs) and the multi-speaker model (speaker projections in
    every GLU layer) under tp = 2 against their replicated forward."""
    cfg = getattr(tb, name)(**dict(
        {"nyanko": TINY_NYANKO,
         "deepvoice3_multispeaker": TINY_MULTISPEAKER}[name], dropout=0.0))
    convT = {p + ".v" for p in t_mesh.convT_layers(cfg)}
    assert len(convT) == 2
    want = one_process["tp_builders"][name]["outputs"]
    for r in tp_ranks:
        got = r["tp_builders"][name]
        assert got["sharded"] and not convT & set(got["sharded"])
        if name == "deepvoice3_multispeaker":
            assert any("speaker_proj" in k for k in got["sharded"])
        for g, w in zip(got["outputs"], want):
            scale = max(1.0, float(np.abs(w).max()))
            assert maxdiff(g, w) <= 1e-5 * scale


def test_tp_collectives_go_through_the_wrapper(tp_ranks):
    """Every collective of the tp session went through parallel.mesh's
    wrapper: the forward's gathers, the backward's reductions, the
    broadcast of the parameters and the norm's reduction."""
    counts = tp_ranks[0]["collectives"]
    assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
    assert counts["broadcast"] > 0
    assert counts == tp_ranks[1]["collectives"]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_under_dp_tp_and_jax_load(dptp_ranks):
    r0 = dptp_ranks[0]["ckpt"]
    assert r0["step"] == 2
    for k, v in r0["whole"].items():
        assert np.array_equal(r0["resumed"][k], v), k
    assert [r["ckpt"]["wrote"] for r in dptp_ranks] == [True] + [False] * 3
    assert os.listdir(os.path.dirname(os.path.dirname(r0["path"]))) == [
        "rank0"]
    cfg_j = jb.deepvoice3(**ranks.CFG)
    template = jb.model_init(jax.random.PRNGKey(1), cfg_j)
    hp = _jax_hp()
    opt = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    params, opt_state, step, _ = j_ckpt.load_checkpoint(
        r0["path"], template, opt.init(template))
    assert step == 2 and opt_state is not None
    loaded = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    assert loaded.keys() == r0["whole"].keys()


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_dp_tts():
    from deepvoice3_pytorch_tpu.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu.frontend import en
    from deepvoice3_pytorch_tpu.hparams import default_hparams
    from deepvoice3_pytorch_tpu.synthesis import tts_batch

    hp = default_hparams()
    hp.parse(TTS_HP)
    cfg = jb.deepvoice3(**ranks.CFG)
    params = jb.model_init(jax.random.PRNGKey(0), cfg)
    mp = pytest.MonkeyPatch()
    mp.setenv("DV3_PALLAS_GL", "1")
    try:
        return tts_batch(params, cfg, AudioProcessor(hp), en, TEXTS,
                         mesh=j_mesh.make_mesh(4, 1), fused=True, **TTS_KW)
    finally:
        mp.undo()


def test_dp_tts_batch_matches_one_process_and_jax(dp_ranks, one_process,
                                                  jax_dp_tts):
    want = one_process["tts"]
    for r in dp_ranks:
        got = r["tts"]
        assert len(got) == len(want) == len(jax_dp_tts) == 3
        for g, w, j in zip(got, want, jax_dp_tts):
            assert g["num_decoder_steps"] == w["num_decoder_steps"] == \
                j["num_decoder_steps"]
            for k in ("mel", "linear", "alignment"):
                assert maxdiff(g[k], w[k]) <= 3e-4, k
                assert maxdiff(g[k], j[k]) <= 3e-4, k
            assert maxdiff(g["waveform"], w["waveform"]) <= 5e-2
            assert maxdiff(g["waveform"], j["waveform"]) < \
                0.12 * np.abs(j["waveform"]).max()


def test_dp_tts_batch_with_speakers_matches_one_process(dp_ranks,
                                                        one_process):
    """The multi-speaker model, a speaker a text: the speaker ids travel
    with the rows."""
    want = one_process["tts_speakers"]
    for r in dp_ranks:
        got = r["tts_speakers"]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g["num_decoder_steps"] == w["num_decoder_steps"]
            for k in ("mel", "linear", "alignment"):
                assert maxdiff(g[k], w[k]) <= 3e-4, k
            assert maxdiff(g["waveform"], w["waveform"]) <= 5e-2
