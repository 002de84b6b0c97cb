# coding: utf-8
"""Sequence parallelism in the port (parallel/mesh.py `seq_sharding`,
`shard_batch(sp=True)`, ops/core.py `sequence_parallel`, the sp train step)
against the one-process port and the JAX package's dp x sp step, on the CPU.

The port's ranks are processes of tests/torch_mesh_ranks.py (no JAX) in a
gloo group through a file under tmp_path; two sessions run every rank body
once: sp (mesh 2 x 2, dp x sp with the tp slices as storage) and sp4 (1 x 4,
where the decoder's dilation-27 conv reaches every rank back and a halo
spans three ranks). The JAX side runs in this process on the 8 virtual CPU
devices of tests/conftest.py. Dropout is 0 unless a test says otherwise.

Bars (tests/test_multichip.py's and tests/test_torch_mesh.py's):
  * the sp step against the one-process port: 2e-6 on every parameter, the
    loss 1e-6 relative, grad_norm 1e-5 relative;
  * against JAX's dp = 4 x sp = 2 step on the same batch and parameters:
    5e-5 on the parameters, the loss and grad_norm 1e-5 relative;
  * the halo conv against the whole-sequence conv: values and input
    gradients 1e-6 of their scale, weight gradients 1e-5 of theirs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu import builder as jb
from deepvoice3_pytorch_tpu.parallel import mesh as j_mesh
from deepvoice3_pytorch_tpu.training import trainer as jt
from deepvoice3_pytorch_tpu_torch import builder as tb
from deepvoice3_pytorch_tpu_torch.params import flatten_tree, model_init
from deepvoice3_pytorch_tpu_torch.parallel import mesh as t_mesh

import torch_mesh_ranks as ranks
from torch_port_common import TINY_MULTISPEAKER, TINY_NYANKO, maxdiff

# (kw, dilation, causal) of the halo convs: halos of 2 to 12 frames against
# blocks of 4 and 8
HALO_CONVS = [(3, 1, True), (5, 3, True), (3, 9, False), (5, 2, False)]
HALO_GROUPS = (2, 1, 2, 1)          # 4 frames a group: blocks 8, 4, 8, 4


def _params_np(cfg_kw, seed=0):
    return flatten_tree(jax.tree_util.tree_map(
        np.asarray, jb.model_init(jax.random.PRNGKey(seed),
                                  jb.deepvoice3(**cfg_kw))))


def _sp_builder(name, cfg_kw, extra):
    """A tiny builder at dropout 0 with seeded port parameters, its loss
    hparams (r and downsample_step of the config) and a batch of 8 decoder
    groups."""
    cfg_kw = dict(cfg_kw, dropout=0.0)
    params = model_init(getattr(tb, name)(**cfg_kw),
                        torch.Generator().manual_seed(5), "cpu")
    hp = dict(ranks.HP, outputs_per_step=cfg_kw["r"],
              downsample_step=cfg_kw["downsample_step"],
              fft_size=2 * (cfg_kw["linear_dim"] - 1))
    b = ranks.batch(seed=3, B=4, T_text=12, T_dec=8, r=cfg_kw["r"],
                    mel_dim=cfg_kw["mel_dim"],
                    linear_dim=cfg_kw["linear_dim"],
                    downsample_step=cfg_kw["downsample_step"])
    b.update(extra)
    return {"cfg": cfg_kw, "hp": hp, "batch": b,
            "params": {k: v.numpy() for k, v in params.state_dict().items()}}


def _halo_params():
    rs = np.random.RandomState(11)
    out = []
    for kw, _, _ in HALO_CONVS:
        v = rs.randn(kw, 8, 6).astype(np.float32)
        out.append({"v": v, "g": np.sqrt((v * v).sum((0, 1))) * 1.3,
                    "b": rs.randn(6).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def spec():
    rs = np.random.RandomState(9)
    return {
        "builder": "deepvoice3", "cfg": ranks.CFG,
        "params": _params_np(ranks.CFG), "hp": ranks.HP,
        "batches": [ranks.batch(seed=i) for i in range(2)],
        "sp_ragged": [ranks.batch(T_dec=7)],
        "dropout_cfg": dict(ranks.CFG, dropout=0.05),
        "sp_builders": {
            "nyanko": _sp_builder("nyanko", TINY_NYANKO, {}),
            "deepvoice3_multispeaker": _sp_builder(
                "deepvoice3_multispeaker", TINY_MULTISPEAKER,
                {"speaker_ids": np.asarray([0, 2, 4, 1])})},
        "halo_convs": HALO_CONVS, "halo_groups": HALO_GROUPS,
        "halo_params": _halo_params(),
        "halo_x": rs.randn(2, 24, 8).astype(np.float32),
        "halo_dy": rs.randn(2, 24, 6).astype(np.float32),
    }


@pytest.fixture(scope="module")
def sp_ranks(spec, tmp_path_factory):
    return ranks.spawn("sp", spec, tmp_path_factory.mktemp("sp"))


@pytest.fixture(scope="module")
def sp4_ranks(spec, tmp_path_factory):
    return ranks.spawn("sp4", spec, tmp_path_factory.mktemp("sp4"))


@pytest.fixture(scope="module")
def one_process(spec):
    """The rank bodies in this process, without a mesh."""
    cpu = torch.device("cpu")
    return {name: getattr(ranks, "body_" + name)(spec, None, cpu)
            for name in ("sp_step", "sp_ragged", "sp_builders", "sp4_step",
                         "sp_dropout", "halo_conv")}


def _close(got, want, atol, what):
    assert got.keys() == want.keys()
    worst = max(maxdiff(got[k], want[k]) for k in want)
    assert worst <= atol, (what, worst)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _assert_step(got, want):
    _close(got["params"], want["params"], 2e-6, "sp step vs one process")
    for g, w in zip(got["metrics"], want["metrics"]):
        assert _rel(g["loss"], w["loss"]) <= 1e-6
        assert _rel(g["grad_norm"], w["grad_norm"]) <= 1e-5


def _jax_sp_run(batch):
    """JAX's dp = 4 x sp = 2 step (tests/test_multichip.py's
    test_sp2_step_matches_single_device): (parameters, loss, grad_norm)."""
    hp = type("HP", (), dict(ranks.HP))()
    cfg = jb.deepvoice3(**ranks.CFG)
    params = jb.model_init(jax.random.PRNGKey(0), cfg)
    opt = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    mesh = j_mesh.make_mesh(n_data=4, n_model=2)
    step = jt.make_train_step(cfg, jt.loss_config_from_hparams(hp), opt,
                              jt.trainable_mask(params, cfg),
                              seq_sharding=j_mesh.seq_sharding(mesh))
    state = jt.init_train_state(j_mesh.shard_params(
        jax.tree.map(jnp.array, params), mesh, tp=True), opt)
    state, m = step(state, j_mesh.shard_batch(mesh, batch, sp=True),
                    jax.random.PRNGKey(0))
    return (flatten_tree(jax.tree_util.tree_map(np.asarray, state.params)),
            float(m["loss"]), float(m["grad_norm"]))


# ---------------------------------------------------------------------------
# the frame blocks: no process group needed
# ---------------------------------------------------------------------------


class _Coordinate:
    """The DeviceMesh surface shard_batch reads, at one (data, model)
    coordinate."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def get_local_rank(self, axis):
        return self.coord[self.mesh_dim_names.index(axis)]


def test_shard_batch_sp_matches_jax_addressable_shards():
    """mel and y of every (data, model) rank are the JAX shards of
    shard_batch(sp=True) on the 4 x 2 mesh; the decoder-rate entries follow
    the same frames, and the r target frames after each block ride along."""
    mesh = j_mesh.make_mesh(n_data=4, n_model=2)
    b = ranks.batch()
    placed = j_mesh.shard_batch(mesh, b, sp=True)
    r = 4
    for k in ("mel", "y"):
        assert t_mesh.MODEL_AXIS in str(placed[k].sharding.spec)
        for s in placed[k].addressable_shards:
            d = s.index[0].start // 2
            m = s.index[1].start // 16
            got = t_mesh.shard_batch(_Coordinate((4, 2), (d, m)), b, sp=True)
            assert np.array_equal(got[k], np.asarray(s.data)), k
            assert got["frame_groups"] == (4, 4)
            rows = slice(2 * d, 2 * d + 2)
            assert np.array_equal(got["frame_positions"],
                                  b["frame_positions"][rows, 4 * m:4 * m + 4])
            assert np.array_equal(got["done"], b["done"][rows,
                                                         4 * m:4 * m + 4])
            nxt = got[t_mesh.NEXT_KEYS[k]]
            want = b[k][rows, 16 * (m + 1):16 * (m + 1) + r]
            assert np.array_equal(nxt[:, :want.shape[1]], want)
            assert not nxt[:, want.shape[1]:].any()


def test_shard_batch_sp_splits_ragged_frames_on_decoder_groups():
    """T_dec = 7 over two model ranks: blocks of 4 and 3 decoder groups
    (16 and 12 mel frames). JAX's GSPMD cuts the 28 frames 14 / 14, inside
    a group; the port keeps whole groups, since each rank reshapes its
    block into them."""
    b = ranks.batch(T_dec=7)
    got = [t_mesh.shard_batch(_Coordinate((1, 2), (0, m)), b, sp=True)
           for m in range(2)]
    assert [g["frame_groups"] for g in got] == [(4, 3)] * 2
    assert [g["mel"].shape[1] for g in got] == [16, 12]
    assert np.array_equal(np.concatenate([g["y"] for g in got], 1), b["y"])
    assert np.array_equal(got[0]["mel_next"], b["mel"][:, 16:20])
    assert t_mesh.frame_groups(5, 4) == (2, 1, 1, 1)
    with pytest.raises(ValueError, match="do not split"):
        t_mesh.frame_groups(3, 4)


def test_halo_plan_reaches_as_many_ranks_as_it_needs():
    """A causal halo of 10 frames before rank 3's block, blocks of 4: the
    last 2 frames of rank 0 and all of ranks 1 and 2; past the start, the
    zero frame."""
    plan = t_mesh.halo_plan((4, 4, 4, 4), 3, 10, 0)
    strip = plan.strip
    assert strip == 10 and plan.zero == 40
    want = [0 * strip + 8, 0 * strip + 9] + [strip + 6 + i for i in range(4)]
    want += [2 * strip + 6 + i for i in range(4)]
    assert list(plan.index) == want
    plan = t_mesh.halo_plan((4, 4, 4, 4), 0, 3, 5)
    assert list(plan.index) == [plan.zero] * 3 + [
        1 * 8 + 3 + i for i in range(4)] + [2 * 8 + 3]


# ---------------------------------------------------------------------------
# the halo conv (1 x 4)
# ---------------------------------------------------------------------------


def test_halo_conv_matches_whole_sequence(sp4_ranks, one_process):
    """Each rank's block of every conv (causal and not, halos longer than a
    block) and its input gradient are the whole-sequence conv's rows; the
    weight gradients summed over the ranks are the whole conv's."""
    want = one_process["halo_conv"]["convs"]
    for r in sp4_ranks:
        for got, w in zip(r["halo_conv"]["convs"], want):
            rows = slice(*got["rows"])
            scale = max(1.0, float(np.abs(w["y"]).max()))
            assert maxdiff(got["y"], w["y"][:, rows]) <= 1e-6 * scale
            scale = max(1.0, float(np.abs(w["dx"]).max()))
            assert maxdiff(got["dx"], w["dx"][:, rows]) <= 1e-6 * scale
            for k, g in w["grads"].items():
                scale = max(1.0, float(np.abs(g).max()))
                assert maxdiff(got["grads"][k], g) <= 1e-5 * scale, k


def test_halo_exchanges_go_through_the_wrapper(sp4_ranks):
    """A halo exchange a conv forward (one all-gather of the strips) and
    one a backward (one all-reduce), on every rank alike."""
    n = len(HALO_CONVS)
    for r in sp4_ranks:
        c = r["halo_conv"]["collectives"]
        assert c["halo"] == 2 * n
        assert c["all_gather"] == n and c["all_reduce"] >= n
        assert c["halo_bytes"] > 0
    assert all(r["halo_conv"]["collectives"] ==
               sp4_ranks[0]["halo_conv"]["collectives"] for r in sp4_ranks)


# ---------------------------------------------------------------------------
# the sp train step
# ---------------------------------------------------------------------------


def test_sp2_step_matches_one_process_and_jax(sp_ranks, one_process, spec):
    """dp = 2 x sp = 2: one step against the one-process port and against
    JAX's dp = 4 x sp = 2 step on the same batch and parameters."""
    got = sp_ranks[0]["sp_step"]
    _assert_step(got, one_process["sp_step"])
    for r in sp_ranks[1:]:
        assert all(np.array_equal(r["sp_step"]["params"][k], v)
                   for k, v in got["params"].items())
    jp, jl, jn = _jax_sp_run(spec["batches"][0])
    _close(got["params"], jp, 5e-5, "dp=2 x sp=2 vs JAX 4 x 2")
    assert _rel(got["metrics"][0]["loss"], jl) <= 1e-5
    assert _rel(got["metrics"][0]["grad_norm"], jn) <= 1e-5


def test_sp2_ragged_frames_match_one_process_and_jax(sp_ranks, one_process,
                                                     spec):
    """T_dec = 7 (28 mel frames): blocks of 4 and 3 decoder groups."""
    got = sp_ranks[0]["sp_ragged"]
    _assert_step(got, one_process["sp_ragged"])
    jp, jl, jn = _jax_sp_run(spec["sp_ragged"][0])
    _close(got["params"], jp, 5e-5, "ragged sp vs JAX 4 x 2")
    assert _rel(got["metrics"][0]["loss"], jl) <= 1e-5
    assert _rel(got["metrics"][0]["grad_norm"], jn) <= 1e-5


def test_sp4_step_with_halos_across_ranks_matches_one_process(
        sp4_ranks, one_process):
    """sp = 4: blocks of 2 decoder groups; the decoder's kw = 5, dilation
    27 conv needs 108 groups of context, every block before its own."""
    for r in sp4_ranks:
        _assert_step(r["sp4_step"], one_process["sp4_step"])


@pytest.mark.parametrize("name", ["nyanko", "deepvoice3_multispeaker"])
def test_sp_step_of_the_other_builders_matches_one_process(
        sp_ranks, one_process, name):
    """nyanko (highway stacks, r = 1, downsample 4, two transposed convs
    upsampling the blocks) and the multi-speaker model (speaker biases
    expanded to each block)."""
    _assert_step(sp_ranks[0]["sp_builders"][name],
                 one_process["sp_builders"][name])


def test_sp_dropout_blocks_draw_the_whole_sequence_mask(sp4_ranks,
                                                        one_process):
    """At dropout 0.05 on a 1 x 4 mesh each block keeps its frames of a
    mask drawn for the whole sequence from the one-process seed: two steps
    give the one-process numbers."""
    want = one_process["sp_dropout"]
    assert want["metrics"][0]["loss"] != one_process["sp4_step"][
        "metrics"][0]["loss"]
    for r in sp4_ranks:
        _assert_step(r["sp_dropout"], want)


def test_sp_collectives_go_through_the_wrapper(sp_ranks):
    """The sp step's halo exchanges, the gather of the sliced weights and
    the reductions all went through parallel.mesh's wrapper, alike on
    every rank."""
    c = sp_ranks[0]["collectives"]
    assert c["halo"] > 0 and c["all_gather"] > 0 and c["all_reduce"] > 0
    assert c["broadcast"] > 0
    assert all(r["collectives"] == c for r in sp_ranks)
