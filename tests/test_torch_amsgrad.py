# coding: utf-8
"""`hparams.amsgrad` in the PyTorch port against the JAX package (optax's
`amsgrad`, `scale_by_amsgrad`): the train step, its checkpoints in both
directions, and the optimizer fingerprint, at the tiny LJSpeech-structure
configuration of tests/torch_port_common.py, dropout 0, the same batch
every step.

Tolerances are the Adam parity tests' (tests/test_torch_training.py,
tests/test_torch_checkpoint.py): the first step's loss 1e-5 relative and
grad_norm 1e-4 (two frameworks' f32 forward and backward), parameters after
it 5e-5, the ten-step loss trajectory 1e-4 relative; the optimizer's
moments after one step 1e-5 of their largest value over the model. Files
are exact: a checkpoint loads bit for bit, the port writes JAX's bytes
back, and the fingerprints are equal strings."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu.training import checkpoint as jck
from deepvoice3_pytorch_tpu.training import trainer as jt
from deepvoice3_pytorch_tpu_torch.params import flatten_tree
from deepvoice3_pytorch_tpu_torch.training import checkpoint as tck
from deepvoice3_pytorch_tpu_torch.training import trainer as tt

from test_torch_checkpoint import _HP, _batch, _rel, tree_params
from torch_port_common import jax_params, maxdiff, tiny_configs


def _hp(amsgrad=True, **kw):
    hp = _HP()
    hp.amsgrad = amsgrad
    for k, v in kw.items():
        setattr(hp, k, v)
    return hp


def _np(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def _jax_moments(opt_state):
    """(count, {mu, nu, nu_max} as flat dicts) of JAX's amsgrad state."""
    st = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "nu_max"))
        if hasattr(s, "nu_max")][0]
    return int(st.count), {k: _np(getattr(st, k))
                           for k in ("mu", "nu", "nu_max")}


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = tiny_configs("deepvoice3", dropout=0.0)
    init = jax_params(cfg_j, seed=0)
    hp = _hp()
    opt = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    step = jt.make_train_step(cfg_j, jt.loss_config_from_hparams(hp), opt,
                              jt.trainable_mask(init, cfg_j))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, init=init, opt=opt, step=step,
                batch=_batch(False))


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


def _port_setup(cfg_t, params, hp=None):
    hp = _hp() if hp is None else hp
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


def _assert_step(jm, tm, jp, tp):
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-4
    for k in jp:
        assert maxdiff(tp[k], jp[k]) <= 5e-5, k


@pytest.fixture(scope="module")
def runs(setup):
    """Ten steps of each package from the same parameters; the state after
    the first step of each."""
    jstate, jm = _jax_steps(setup, 1)
    j_first = (_np(jstate.params), _jax_moments(jstate.opt_state))
    jstate, jm2 = _jax_steps(setup, 9, state=jstate)
    params = tree_params(setup["init"])
    opt, step = _port_setup(setup["cfg_t"], params)
    tstate, tm = _port_steps(step, tt.init_train_state(params, opt),
                             setup["batch"], 1)
    t_first = ({k: v.clone() for k, v in tstate.params.state_dict().items()},
               tstate.opt_state.count,
               {k: {n: v.clone() for n, v in getattr(tstate.opt_state,
                                                     k).items()}
                for k in ("mu", "nu", "nu_max")})
    tstate, tm2 = _port_steps(step, tstate, setup["batch"], 9)
    return (jm + jm2, j_first, jstate), (tm + tm2, t_first, tstate)


def test_amsgrad_step_matches_jax(runs):
    (jm, (jp, (jcount, jmom)), _), (tm, (tp, tcount, tmom), _) = runs
    _assert_step(jm[0], tm[0], jp, tp)
    assert tcount == jcount == 1
    for kind in ("mu", "nu", "nu_max"):
        # a moment's largest value over the whole model: some tensors' true
        # gradient is zero (a key projection's bias under the softmax), and
        # theirs is rounding noise at 1e-11
        scale = max(float(np.abs(w).max()) for w in jmom[kind].values())
        for k, want in jmom[kind].items():
            assert maxdiff(tmom[kind][k], want) <= 1e-5 * scale, (kind, k)


def test_amsgrad_ten_step_trajectory_matches_jax(runs):
    (jm, _, jstate), (tm, _, tstate) = runs
    want = np.asarray([m["loss"] for m in jm])
    got = np.asarray([m["loss"] for m in tm])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    # the maximum is engaged: somewhere nu_max exceeds the bias-corrected
    # second moment it was taken from (b2 = 0.9 forgets a large early
    # gradient), in both packages
    st = tstate.opt_state
    bc2 = 1.0 - 0.9 ** st.count
    assert any(bool((st.nu_max[k] > st.nu[k] / bc2 * (1 + 1e-3)).any())
               for k in st.nu)
    _, jmom = _jax_moments(jstate.opt_state)
    assert any(bool((jmom["nu_max"][k] > jmom["nu"][k] / bc2
                     * (1 + 1e-3)).any()) for k in jmom["nu"])


def test_jax_amsgrad_checkpoint_resumes_in_the_port(tmp_path, setup):
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
    count, mom = _jax_moments(state.opt_state)
    assert opt_state.count == count == 3
    want = _np(state.params)
    got = params.state_dict()
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k
        for kind in ("mu", "nu", "nu_max"):
            assert np.array_equal(getattr(opt_state, kind)[k].numpy(),
                                  mom[kind][k]), (kind, k)
    again = tck.save_checkpoint(str(tmp_path / "port"), params, opt_state,
                                3, 2)
    assert open(again, "rb").read() == open(path, "rb").read()

    tstate, tm = _port_steps(step, tt.TrainState(params, opt_state, 3),
                             batch, 1)
    state, jm = _jax_steps(setup, 1, state=state)
    _assert_step(jm[0], tm[0], _np(state.params), tstate.params.state_dict())


def test_port_amsgrad_checkpoint_resumes_in_jax(tmp_path, setup):
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
    count, mom = _jax_moments(jopt_state)
    assert count == 3
    jp = _np(jparams)
    for k, v in tstate.params.state_dict().items():
        assert np.array_equal(jp[k], v.numpy()), k
        for kind in ("mu", "nu", "nu_max"):
            assert np.array_equal(
                mom[kind][k], getattr(tstate.opt_state, kind)[k].numpy())

    jstate, jm = _jax_steps(setup, 1, state=jt.TrainState(
        jparams, jopt_state, jnp.int32(3)))
    tstate, tm = _port_steps(step, tstate, batch, 1)
    _assert_step(jm[0], tm[0], _np(jstate.params), tstate.params.state_dict())


@pytest.mark.parametrize("clip,wd", [(0.0, 0.0), (0.1, 0.0), (0.1, 1e-4)])
def test_amsgrad_fingerprint_matches_jax(clip, wd):
    cfg_j, _ = tiny_configs("deepvoice3_multispeaker")
    init = jax_params(cfg_j)
    hp = _hp(clip_thresh=clip, weight_decay=wd)
    jopt = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    want = jck.opt_state_fingerprint(jopt.init(init))
    params = tree_params(init)
    state = tt.init_train_state(params, tt.make_optimizer(
        hp, tt.make_lr_fn(hp)))
    assert tck.opt_state_fingerprint(state.opt_state, params) == want
    adam = jck.opt_state_fingerprint(jt.make_optimizer(
        _hp(False), jt.make_lr_fn(hp)).init(init))
    assert want != adam


@pytest.mark.parametrize("saved,resumed", [(False, True), (True, False)])
def test_other_optimizers_checkpoint_is_refused(tmp_path, saved, resumed):
    """An adam file into an amsgrad optimizer, and the reverse: the
    fingerprint's mismatch message; with reset_optimizer the parameters
    load and the optimizer starts afresh."""
    cfg_j, _ = tiny_configs("deepvoice3")
    params = tree_params(jax_params(cfg_j))
    leaves = {k: v.detach() for k, v in params.named_parameters()}
    hp = _hp(saved)
    state = tt.make_optimizer(hp, tt.make_lr_fn(hp)).init(leaves)
    path = tck.save_checkpoint(str(tmp_path), params, state, 0, 0)
    hp = _hp(resumed)
    other = tt.make_optimizer(hp, tt.make_lr_fn(hp)).init(leaves)
    with pytest.raises(ValueError, match="structure mismatch"):
        tck.load_checkpoint(path, params, other)
    _, opt_state, _, _ = tck.load_checkpoint(path, params, other,
                                             reset_optimizer=True)
    assert opt_state is None
    # the leaf count alone also refuses (a file without a fingerprint)
    with pytest.raises(ValueError, match="leaves"):
        tck.unflatten_opt_state(other, tck.flatten_opt_state(state, params),
                                params)
