# coding: utf-8
"""The port's checkpoints (deepvoice3_pytorch_tpu_torch/training/checkpoint.py
and utils/msgpack.py) against the JAX package's on the CPU.

  * the msgpack codec against flax.serialization both ways, and byte for
    byte;
  * a checkpoint the JAX package wrote after three steps loads into the port
    bit for bit (parameters, Adam's mu and nu, the count, step and epoch),
    the port writes the same bytes back, and its fourth step matches JAX's
    fourth step at the bars of tests/test_torch_training.py (loss 1e-5
    relative, grad norm 1e-4, parameters 5e-5);
  * the reverse: the port writes after three steps, JAX's load_checkpoint
    with its optax template accepts the fingerprint, and JAX's fourth step
    matches the port's;
  * the optimizer fingerprint for the four chains, the seq2seq / postnet
    halves, restore_parts, load_embedding, latest_checkpoint, the async
    save and the pickle format.

Tiny configurations of tests/torch_port_common.py, dropout 0.
"""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization as flax_ser

from deepvoice3_pytorch_tpu.training import checkpoint as jck
from deepvoice3_pytorch_tpu.training import trainer as jt
from deepvoice3_pytorch_tpu_torch.params import ParamTree, flatten_tree
from deepvoice3_pytorch_tpu_torch.training import checkpoint as tck
from deepvoice3_pytorch_tpu_torch.training import trainer as tt
from deepvoice3_pytorch_tpu_torch.utils import msgpack

from torch_port_common import jax_params, maxdiff, tiny_configs


class _HP:
    outputs_per_step = 1
    downsample_step = 4
    masked_loss_weight = 0.5
    binary_divergence_weight = 0.1
    priority_freq = 3000
    priority_freq_weight = 0.0
    use_guided_attention = True
    guided_attention_sigma = 0.2
    sample_rate = 22050
    fft_size = 128
    adam_beta1 = 0.5
    adam_beta2 = 0.9
    adam_eps = 1e-6
    amsgrad = False
    clip_thresh = 0.1
    weight_decay = 0.0
    initial_learning_rate = 5e-4
    lr_schedule = "noam_learning_rate_decay"
    lr_schedule_kwargs = {}


def _batch(speakers):
    rs = np.random.RandomState(3)
    B, T_text, T_dec = 4, 12, 16
    frames = np.asarray([16, 12, 9, 14])
    batch = {
        "x": rs.randint(1, 149, (B, T_text)).astype(np.int32),
        "input_lengths": np.asarray([12, 10, 7, 12], np.int32),
        "mel": rs.rand(B, T_dec, 16).astype(np.float32),
        "y": rs.rand(B, 4 * T_dec, 65).astype(np.float32),
        "text_positions": np.tile(np.arange(1, T_text + 1),
                                  (B, 1)).astype(np.int32),
        "frame_positions": np.tile(np.arange(1, T_dec + 1),
                                   (B, 1)).astype(np.int32),
        "done": (np.arange(T_dec)[None, :, None]
                 >= frames[:, None, None] - 1).astype(np.float32),
        "target_lengths": (4 * frames).astype(np.int32),
    }
    if speakers:
        batch["speaker_ids"] = np.asarray([0, 3, 1, 4], np.int32)
    return batch


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def tree_params(np_tree):
    """A ParamTree with the JAX tree's structure, empty entries included (as
    model_init builds it)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return torch.from_numpy(np.array(t, np.float32))
    return ParamTree(conv(np_tree))


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
        2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15, -2 ** 15 - 1,
        -2 ** 31, -2 ** 31 - 1, -2 ** 63]
STRINGS = ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 70000, "é✓"]


def _arrays():
    rs = np.random.RandomState(0)
    return [rs.rand(3, 4).astype(np.float32), rs.rand(5),
            rs.randint(-9, 9, (2, 3, 2)).astype(np.int32),
            np.arange(6, dtype=np.int64), np.asarray(7, np.int32),
            np.zeros((0, 3), np.float32), rs.rand(300).astype(np.float16),
            (rs.rand(3) > 0.5), np.arange(20000, dtype=np.uint8),
            rs.rand(70000).astype(np.float32)]


def _objects():
    return {
        "ints": INTS, "floats": [0.0, -1.5, 3.25e-300, 1e300],
        "strings": STRINGS, "misc": [None, True, False, b"\x00\x01"],
        "arrays": _arrays(),
        "scalars": [np.int32(5), np.float32(2.5), np.int64(-3)],
        "nested": {"a": [{"v": np.ones(2, np.float32)}, {}],
                   # flax writes a map's keys sorted
                   "b": {k: int(k) for k in sorted(map(str, range(20)))},
                   "c": list(range(70000))},
    }


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("key", sorted(_objects()))
def test_msgpack_matches_flax_both_ways(key):
    """Port bytes equal flax's; each side decodes the other's bytes to equal
    arrays and scalars."""
    obj = {key: _objects()[key]}
    flax_bytes = flax_ser.msgpack_serialize(obj)
    port_bytes = msgpack.packb(obj)
    assert port_bytes == flax_bytes
    _same(flax_ser.msgpack_restore(port_bytes), msgpack.unpackb(flax_bytes))
    _same(msgpack.unpackb(flax_bytes), flax_ser.msgpack_restore(flax_bytes))


def test_msgpack_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="chunked"):
        msgpack.unpackb(msgpack.packb({"__msgpack_chunked_array__": True}))
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack.unpackb(flax_ser.msgpack_serialize([1 + 2j]))
    with pytest.raises(ValueError, match="trailing"):
        msgpack.unpackb(msgpack.packb(1) + b"\x01")
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(msgpack.packb("abc")[:-1])


# ---------------------------------------------------------------------------
# resume across the packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["deepvoice3", "nyanko",
                                        "deepvoice3_multispeaker"])
def setup(request):
    """One builder's configs, initial parameters, batch and JAX step (built
    once: its compile is most of these tests' time)."""
    builder = request.param
    cfg_j, cfg_t = tiny_configs(builder, dropout=0.0)
    init = jax_params(cfg_j, seed=0)
    hp = _HP()
    opt = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    step = jt.make_train_step(cfg_j, jt.loss_config_from_hparams(hp), opt,
                              jt.trainable_mask(init, cfg_j))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, init=init, opt=opt, step=step,
                batch=_batch(builder == "deepvoice3_multispeaker"))


def _jax_steps(setup, n, state=None):
    if state is None:
        state = jt.init_train_state(jax.tree.map(jnp.array, setup["init"]),
                                    setup["opt"])
    metrics = []
    for i in range(n):
        state, m = setup["step"](state,
                                 jax.tree.map(jnp.asarray, setup["batch"]),
                                 jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port_setup(cfg_t, params):
    hp = _HP()
    opt = tt.make_optimizer(hp, tt.make_lr_fn(hp))
    step = tt.make_train_step(cfg_t, tt.loss_config_from_hparams(hp), opt,
                              tt.trainable_mask(params, cfg_t))
    return opt, step


def _port_steps(step, state, batch, n):
    b = tt.batch_to(batch, "cpu")
    metrics = []
    for _ in range(n):
        state, m = step(state, b, torch.Generator().manual_seed(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _jax_moments(opt_state):
    """(count, mu tree, nu tree) of JAX's chain state."""
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")][0]
    return int(adam.count), adam.mu, adam.nu


def _assert_step(jm, tm, jp, tp):
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-4
    for k in jp:
        assert maxdiff(tp[k], jp[k]) <= 5e-5, k


def test_jax_checkpoint_loads_bit_for_bit_and_resumes(tmp_path, setup):
    cfg_j, cfg_t, batch = setup["cfg_j"], setup["cfg_t"], setup["batch"]
    state, _ = _jax_steps(setup, 3)
    path = jck.save_checkpoint(str(tmp_path / "jax"), state.params,
                               state.opt_state, 3, 2)

    params = tree_params(jax_params(cfg_j, seed=1))   # other values
    opt, step = _port_setup(cfg_t, params)
    tstate = tt.init_train_state(params, opt)
    params, opt_state, gstep, gepoch = tck.load_checkpoint(
        path, params, tstate.opt_state)
    assert (gstep, gepoch) == (3, 2)
    count, mu, nu = _jax_moments(state.opt_state)
    assert opt_state.count == count == 3
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, state.params))
    mu, nu = (flatten_tree(jax.tree_util.tree_map(np.asarray, t))
              for t in (mu, nu))
    got = params.state_dict()
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k
        assert np.array_equal(opt_state.mu[k].numpy(), mu[k]), k
        assert np.array_equal(opt_state.nu[k].numpy(), nu[k]), k

    # the port writes the same bytes back
    again = tck.save_checkpoint(str(tmp_path / "port"), params, opt_state,
                                3, 2)
    assert open(again, "rb").read() == open(path, "rb").read()

    # step 4 of each package from the file
    tstate = tt.TrainState(params, opt_state, 3)
    tstate, tm = _port_steps(step, tstate, batch, 1)
    state, jm = _jax_steps(setup, 1, state=state)
    _assert_step(jm[0], tm[0],
                 flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                     state.params)),
                 tstate.params.state_dict())


def test_port_checkpoint_resumes_in_jax(tmp_path, setup):
    cfg_j, cfg_t, batch = setup["cfg_j"], setup["cfg_t"], setup["batch"]
    params = tree_params(setup["init"])
    opt, step = _port_setup(cfg_t, params)
    tstate, _ = _port_steps(step, tt.init_train_state(params, opt), batch, 3)
    path = tck.save_checkpoint(str(tmp_path), tstate.params,
                               tstate.opt_state, 3, 1)

    template = jax.tree.map(jnp.array, jax_params(cfg_j, seed=1))
    jparams, jopt_state, gstep, gepoch = jck.load_checkpoint(
        path, template, setup["opt"].init(template))
    assert (gstep, gepoch) == (3, 1)
    count, mu, nu = _jax_moments(jopt_state)
    assert count == 3
    got = {k: flatten_tree(jax.tree_util.tree_map(np.asarray, t))
           for k, t in (("p", jparams), ("mu", mu), ("nu", nu))}
    for k, v in tstate.params.state_dict().items():
        assert np.array_equal(got["p"][k], v.numpy()), k
        assert np.array_equal(got["mu"][k], tstate.opt_state.mu[k].numpy())
        assert np.array_equal(got["nu"][k], tstate.opt_state.nu[k].numpy())

    jstate = jt.TrainState(jparams, jopt_state, jnp.int32(3))
    jstate, jm = _jax_steps(setup, 1, state=jstate)
    tstate, tm = _port_steps(step, tstate, batch, 1)
    _assert_step(jm[0], tm[0],
                 flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params)),
                 tstate.params.state_dict())


@pytest.mark.parametrize("clip", [0.0, 0.1])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_opt_fingerprint_matches_jax(clip, wd):
    cfg_j, _ = tiny_configs("deepvoice3_multispeaker")
    init = jax_params(cfg_j)
    hp = _HP()
    hp.clip_thresh, hp.weight_decay = clip, wd
    jopt = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    want = jck.opt_state_fingerprint(jopt.init(init))
    params = tree_params(init)
    topt = tt.make_optimizer(hp, tt.make_lr_fn(hp))
    state = tt.init_train_state(params, topt)
    assert tck.opt_state_fingerprint(state.opt_state, params) == want


def test_mismatched_chain_is_refused(tmp_path):
    cfg_j, _ = tiny_configs("deepvoice3")
    params = tree_params(jax_params(cfg_j))
    hp = _HP()
    state = tt.init_train_state(params, tt.make_optimizer(
        hp, tt.make_lr_fn(hp)))
    path = tck.save_checkpoint(str(tmp_path), params, state.opt_state, 0, 0)
    hp.weight_decay = 1e-4
    other = tt.make_optimizer(hp, tt.make_lr_fn(hp)).init(
        {k: v.detach() for k, v in params.named_parameters()})
    with pytest.raises(ValueError, match="structure mismatch"):
        tck.load_checkpoint(path, params, other)
    _, opt_state, _, _ = tck.load_checkpoint(path, params, other,
                                             reset_optimizer=True)
    assert opt_state is None


# ---------------------------------------------------------------------------
# halves, partial restores, the writer, the pickle format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s2s,pn", [(True, False), (False, True)])
def test_halves_match_jax(tmp_path, s2s, pn):
    cfg_j, _ = tiny_configs("nyanko")
    init = jax_params(cfg_j)
    want = jck.save_checkpoint(str(tmp_path / "jax"), init, None, 7, 1,
                               train_seq2seq=s2s, train_postnet=pn)
    got = tck.save_checkpoint(str(tmp_path / "port"), tree_params(init),
                              None, 7, 1, train_seq2seq=s2s,
                              train_postnet=pn)
    assert os.path.basename(got) == os.path.basename(want)
    assert got.endswith("_seq2seq.ckpt" if s2s else "_postnet.ckpt")
    assert open(got, "rb").read() == open(want, "rb").read()
    # a half loads onto a template and leaves the other half alone
    template = tree_params(jax_params(cfg_j, seed=5))
    before = {k: v.clone() for k, v in template.state_dict().items()}
    tck.load_checkpoint(got, template)
    src = flatten_tree(init)
    for k, v in template.state_dict().items():
        expect = src[k] if k.startswith("converter.") == pn else before[k]
        assert np.array_equal(v.numpy(), np.asarray(expect)), k


def test_restore_parts_and_load_embedding_match_jax(tmp_path):
    """A 5-speaker checkpoint restored into a 3-speaker model: the speaker
    table keeps the template's values, everything else is taken."""
    cfg5, _ = tiny_configs("deepvoice3_multispeaker")
    cfg3, _ = tiny_configs("deepvoice3_multispeaker", n_speakers=3)
    src = jax_params(cfg5, seed=0)
    path = jck.save_checkpoint(str(tmp_path), src, None, 1, 0)
    template = jax_params(cfg3, seed=9)
    want = flatten_tree(jax.tree_util.tree_map(
        np.asarray, jck.restore_parts(path, template)))
    got = tck.restore_parts(path, tree_params(template)).state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert np.array_equal(got["embed_speakers.w"].numpy(),
                          flatten_tree(template)["embed_speakers.w"])

    want = flatten_tree(jax.tree_util.tree_map(
        np.asarray, jck.load_embedding(path, template)))
    got = tck.load_embedding(path, tree_params(template)).state_dict()
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k


def test_latest_checkpoint_matches_jax(tmp_path):
    for name in ["checkpoint_step000000009.ckpt",
                 "checkpoint_step000000010.ckpt",
                 "checkpoint_step000000011_seq2seq.ckpt",
                 "checkpoint_step000000012_postnet.ckpt"]:
        (tmp_path / name).write_bytes(b"")
    for suffix in ("", "_seq2seq", "_postnet"):
        assert tck.latest_checkpoint(str(tmp_path), suffix) == \
            jck.latest_checkpoint(str(tmp_path), suffix)
    assert tck.latest_checkpoint(str(tmp_path / "none")) is None


def test_async_save_equals_sync_save(tmp_path):
    """The parameters and moments are changed in place right after the
    submit; the file still holds the state at the submit."""
    cfg_j, cfg_t = tiny_configs("deepvoice3")
    params = tree_params(jax_params(cfg_j))
    opt, step = _port_setup(cfg_t, params)
    state, _ = _port_steps(step, tt.init_train_state(params, opt),
                           _batch(False), 2)
    sync = tck.save_checkpoint(str(tmp_path / "sync"), params,
                               state.opt_state, 2, 0)
    tensors = list(params.parameters()) + list(state.opt_state.mu.values())
    before = [t.detach().clone() for t in tensors]
    for _ in range(2):      # the second submit reuses the buffers
        path = tck.save_checkpoint(str(tmp_path / "async"), params,
                                   state.opt_state, 2, 0, async_save=True)
        with torch.no_grad():
            torch._foreach_mul_(tensors, 3.0)
        tck.wait_pending_saves()
        assert open(path, "rb").read() == open(sync, "rb").read()
        with torch.no_grad():
            torch._foreach_copy_(tensors, before)


def test_async_save_surfaces_write_errors(tmp_path):
    cfg_j, _ = tiny_configs("deepvoice3")
    params = tree_params(jax_params(cfg_j))
    blocker = tmp_path / "file"
    blocker.write_text("x")
    path = tck.checkpoint_path(str(blocker), 1)
    tck._writer.submit(list(params.parameters()), lambda arrays: {}, path)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        tck.wait_pending_saves()


def test_pickle_checkpoint_loads(tmp_path, monkeypatch):
    """The JAX package writes a pickle when flax is absent."""
    cfg_j, _ = tiny_configs("deepvoice3")
    init = jax_params(cfg_j, seed=2)
    monkeypatch.setattr(jck, "flax_ser", None)
    path = jck.save_checkpoint(str(tmp_path), init, None, 5, 3)
    with open(path, "rb") as f:
        assert isinstance(pickle.load(f), dict)
    params, _, step, epoch = tck.load_checkpoint(
        path, tree_params(jax_params(cfg_j, seed=8)))
    assert (step, epoch) == (5, 3)
    want = flatten_tree(init)
    for k, v in params.state_dict().items():
        assert np.array_equal(v.numpy(), want[k]), k
    (tmp_path / "bad.ckpt").write_bytes(b"\xc1garbage")
    with pytest.raises(ValueError, match="neither"):
        tck.load_checkpoint(str(tmp_path / "bad.ckpt"), params)
