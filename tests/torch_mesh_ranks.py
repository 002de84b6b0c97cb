# coding: utf-8
"""The rank side of tests/test_torch_mesh.py (and of the card's tp case in
tests/test_torch_cuda.py). Each rank is a process of its own (`spawn`):

    python tests/torch_mesh_ranks.py SESSION RANK WORLD INIT_FILE SPEC OUT_DIR

It joins a group (SPEC's "backend", gloo by default) through INIT_FILE
(init_method="file://..."), runs the bodies of SESSION on the inputs
pickled in SPEC (on SPEC's "device", the CPU by default) and pickles what
they return to OUT_DIR/rank<RANK>.pkl.
It imports torch and the port only, never JAX, so a rank pays for neither.
The bodies also run without a mesh in the test's own process (mesh=None),
which gives the one-process numbers.
"""

import contextlib
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deepvoice3_pytorch_tpu_torch import builder as tb  # noqa: E402
from deepvoice3_pytorch_tpu_torch.builder import model_forward  # noqa: E402
from deepvoice3_pytorch_tpu_torch.ops import conv_cuda  # noqa: E402
from deepvoice3_pytorch_tpu_torch.ops import core  # noqa: E402
from deepvoice3_pytorch_tpu_torch.parallel import mesh as mesh_lib  # noqa
from deepvoice3_pytorch_tpu_torch.params import model_init  # noqa: E402
from deepvoice3_pytorch_tpu_torch.training import checkpoint as ckpt  # noqa
from deepvoice3_pytorch_tpu_torch.training import trainer as tt  # noqa: E402

torch.set_num_threads(1)

HP = dict(outputs_per_step=4, downsample_step=1, masked_loss_weight=0.5,
          binary_divergence_weight=0.1, priority_freq=3000,
          priority_freq_weight=0.0, use_guided_attention=True,
          guided_attention_sigma=0.2, sample_rate=22050, fft_size=256,
          adam_beta1=0.5, adam_beta2=0.9, adam_eps=1e-6, amsgrad=False,
          clip_thresh=0.1, weight_decay=0.0, initial_learning_rate=5e-4,
          lr_schedule="noam_learning_rate_decay", lr_schedule_kwargs={})
# the JAX mesh tests' tiny train config (tests/test_training._tiny_cfg)
CFG = dict(n_vocab=149, embed_dim=64, encoder_channels=32,
           decoder_channels=32, converter_channels=32, linear_dim=129, r=4,
           dropout=0.0, max_positions=128)


def batch(seed=0, B=8, T_text=16, T_dec=8, r=4, ragged=False, mel_dim=80,
          linear_dim=129, downsample_step=1):
    """tests/test_training._tiny_batch from `seed`. ragged: frame and text
    lengths that differ row by row; the decoder-domain mask (valid length
    target_lengths // r, from frame r on) then holds 15 frames in the first
    half of the rows and 7 in the second."""
    rs = np.random.RandomState(seed)
    b = {
        "x": rs.randint(1, 149, (B, T_text)).astype(np.int32),
        "input_lengths": np.full((B,), T_text, np.int32),
        "mel": rs.rand(B, T_dec * r, mel_dim).astype(np.float32),
        "y": rs.rand(B, T_dec * r * downsample_step,
                     linear_dim).astype(np.float32),
        "text_positions": np.tile(np.arange(1, T_text + 1),
                                  (B, 1)).astype(np.int32),
        "frame_positions": np.tile(np.arange(1, T_dec + 1),
                                   (B, 1)).astype(np.int32),
        "done": np.ones((B, T_dec, 1), np.float32),
        "target_lengths": np.full((B,), T_dec * r * downsample_step,
                                  np.int32),
    }
    if ragged:
        frames = np.asarray([32, 32, 28, 32, 20, 24, 28, 20], np.int32)
        texts = np.asarray([16, 15, 16, 14, 6, 5, 9, 4], np.int32)
        b["target_lengths"], b["input_lengths"] = frames, texts
        for i, (f, n) in enumerate(zip(frames, texts)):
            b["mel"][i, f:] = b["y"][i, f:] = 0.0
            b["x"][i, n:] = b["text_positions"][i, n:] = 0
            b["done"][i, :f // r - 1] = 0.0
    return b


def build(spec, device):
    """(cfg, params): the spec's config and its numpy parameters in a tree
    that model_init built (so checkpoints keep its empty entries)."""
    cfg = getattr(tb, spec["builder"])(**spec["cfg"])
    params = model_init(cfg, torch.Generator().manual_seed(0), device)
    with torch.no_grad():
        for k, v in params.state_dict().items():
            v.copy_(torch.from_numpy(np.array(spec["params"][k])))
    return cfg, params


def host(t):
    return t.detach().cpu().numpy()


def full_params(mesh, params):
    if mesh is not None:
        params, _ = mesh_lib.gather_state(mesh, params)
    return {k: host(v) for k, v in params.state_dict().items()}


def train(spec, mesh, device, batches, hp=None, tp=False, params=None,
          state=None, sp=False):
    """Steps of the port's train step, one per batch (global batches,
    sharded on a mesh; sp: frames over "model" too). Returns (state,
    metrics per step)."""
    hp = types.SimpleNamespace(**(hp or spec["hp"]))
    cfg = getattr(tb, spec["builder"])(**spec["cfg"])
    opt = tt.make_optimizer(hp, tt.make_lr_fn(hp))
    if state is None:
        if params is None:
            cfg, params = build(spec, device)
        if mesh is not None:
            mesh_lib.shard_params(params, mesh, tp=tp, cfg=cfg)
        state = tt.init_train_state(params, opt)
    mask = tt.trainable_mask(state.params, cfg)
    sp = sp and mesh is not None
    step = tt.make_train_step(
        cfg, tt.loss_config_from_hparams(hp), opt, mask, mesh=mesh,
        seq_sharding=mesh_lib.seq_sharding(mesh) if sp else None)
    gen = torch.Generator(device=device).manual_seed(0)
    metrics = []
    for b in batches:
        if mesh is not None:
            b = mesh_lib.shard_batch(mesh, b, sp=sp)
        state, m = step(state, tt.batch_to(b, device), gen)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def body_dp_train(spec, mesh, device):
    state, metrics = train(spec, mesh, device, spec["batches"][:3])
    return {"params": full_params(mesh, state.params), "metrics": metrics}


def body_ragged(spec, mesh, device):
    state, metrics = train(spec, mesh, device, spec["ragged"])
    return {"params": full_params(mesh, state.params), "metrics": metrics}


def body_tts(spec, mesh, device):
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu_torch.frontend import en
    from deepvoice3_pytorch_tpu_torch.hparams import default_hparams
    from deepvoice3_pytorch_tpu_torch.synthesis import tts_batch

    hp = default_hparams()
    hp.parse(spec["tts_hparams"])
    tspec = dict(spec, cfg=spec["tts_cfg"], params=spec["tts_params"])
    cfg, params = build(tspec, device)
    return tts_batch(params, cfg, AudioProcessor(hp), en, spec["texts"],
                     mesh=mesh, **spec["tts_kw"])


def body_tp_forward(spec, mesh, device):
    """The teacher-forced forward of the spec's forward config (`fwd_cfg`,
    `fwd_params`) on `fwd_batch`, column-parallel on a mesh."""
    cfg, params = build(dict(spec, cfg=spec["fwd_cfg"],
                             params=spec["fwd_params"]), device)
    sliced = []
    if mesh is not None:
        mesh_lib.shard_params(params, mesh, tp=True, cfg=cfg)
        named = dict(params.named_parameters())
        sliced = [named[k] for k in params.tp_layout.axes]
    b = {k: torch.as_tensor(v).to(device) for k, v in spec["fwd_batch"].items()}
    b = {k: v.long() if not v.is_floating_point() else v for k, v in b.items()}
    ctx = contextlib.nullcontext() if mesh is None else core.tensor_parallel(
        mesh_lib.axis_group(mesh, mesh_lib.MODEL_AXIS), sliced)
    conv_cuda.KERNEL.reset_counts()
    with torch.no_grad(), core.conv_mode("kernel"), core.strict_numerics(), \
            ctx:
        out = model_forward(
            params, cfg, b["x"], b["mel"], speaker_ids=b.get("speaker_ids"),
            text_positions=b["text_positions"],
            frame_positions=b["frame_positions"],
            input_lengths=b["input_lengths"], training=False)
    sharded = sorted(params.tp_layout.axes) if mesh is not None else []
    return {"outputs": [host(o) for o in out], "sharded": sharded,
            "b3": dict(conv_cuda.KERNEL.by_entry),
            "local_shapes": {k: tuple(v.shape)
                             for k, v in params.state_dict().items()}}


def body_tp_builders(spec, mesh, device):
    """body_tp_forward for each of spec["builders"] (name -> its config,
    parameters and extra batch entries)."""
    return {name: body_tp_forward(dict(
        spec, builder=name, fwd_cfg=c["cfg"], fwd_params=c["params"],
        fwd_batch=dict(spec["fwd_batch"], **c["extra"])), mesh, device)
        for name, c in spec["builders"].items()}


def body_tts_speakers(spec, mesh, device):
    """body_tts for the multi-speaker builder with a speaker a text."""
    c = spec["builders"]["deepvoice3_multispeaker"]
    return body_tts(dict(spec, builder="deepvoice3_multispeaker",
                         tts_cfg=c["cfg"], tts_params=c["params"],
                         tts_hparams=spec["speaker_tts_hparams"],
                         tts_kw=dict(spec["tts_kw"],
                                     speaker_ids=spec["speaker_ids"])),
                    mesh, device)


def body_clip(spec, mesh, device):
    state, metrics = train(spec, mesh, device, spec["batches"][:2],
                           hp=spec["clip_hp"], tp=True)
    return {"params": full_params(mesh, state.params), "metrics": metrics}


def body_dptp_step(spec, mesh, device):
    state, metrics = train(spec, mesh, device, spec["batches"][:1], tp=True)
    return {"params": full_params(mesh, state.params), "metrics": metrics}


def body_ckpt(spec, mesh, device):
    """2 steps, save (the async writer), load into a fresh tree, 3 steps;
    and 5 steps uninterrupted. Each rank saves into a directory of its
    own, which only the first rank's save creates; all load the first
    rank's file."""
    batches = spec["batches"]
    whole, _ = train(spec, mesh, device, batches, tp=True)
    state, _ = train(spec, mesh, device, batches[:2], tp=True)
    rank = dist.get_rank()
    own = ckpt.save_checkpoint(
        os.path.join(spec["ckpt_dir"], "rank%d" % rank), state.params,
        state.opt_state, 2, 0, mesh=mesh, async_save=True)
    ckpt.wait_pending_saves()
    dist.barrier()
    path = own.replace("rank%d" % rank, "rank0")
    cfg = getattr(tb, spec["builder"])(**spec["cfg"])
    params = model_init(cfg, torch.Generator().manual_seed(1), device)
    if mesh is not None:
        mesh_lib.shard_params(params, mesh, tp=True, cfg=cfg)
    hp = types.SimpleNamespace(**spec["hp"])
    opt = tt.make_optimizer(hp, tt.make_lr_fn(hp))
    resumed = tt.init_train_state(params, opt)
    _, opt_state, step, _ = ckpt.load_checkpoint(path, params,
                                                 resumed.opt_state)
    resumed = tt.TrainState(params, opt_state, step)
    resumed, _ = train(spec, mesh, device, batches[2:], state=resumed)
    return {"path": path, "wrote": os.path.exists(own), "step": step,
            "whole": full_params(mesh, whole.params),
            "resumed": full_params(mesh, resumed.params)}


def body_sp_step(spec, mesh, device):
    """One dp x sp step (tp slices for storage) on the first batch."""
    state, metrics = train(spec, mesh, device, spec["batches"][:1], tp=True,
                           sp=True)
    return {"params": full_params(mesh, state.params), "metrics": metrics,
            "b3": dict(conv_cuda.KERNEL.by_entry)}


def body_sp_ragged(spec, mesh, device):
    """One sp step on a batch of T_dec = 7 (decoder blocks of 4 and 3)."""
    state, metrics = train(spec, mesh, device, spec["sp_ragged"], tp=True,
                           sp=True)
    return {"params": full_params(mesh, state.params), "metrics": metrics}


def body_sp_builders(spec, mesh, device):
    """One sp step of each of spec["sp_builders"] (name -> its config,
    parameters, hparams and batch)."""
    out = {}
    for name, c in spec["sp_builders"].items():
        sub = dict(spec, builder=name, cfg=c["cfg"], params=c["params"],
                   hp=c["hp"])
        state, metrics = train(sub, mesh, device, [c["batch"]], tp=True,
                               sp=True)
        out[name] = {"params": full_params(mesh, state.params),
                     "metrics": metrics}
    return out


def body_sp_dropout(spec, mesh, device):
    """Two sp steps at the spec's dropout (`dropout_cfg`): each block draws
    its frames of the whole sequence's mask."""
    state, metrics = train(dict(spec, cfg=spec["dropout_cfg"]), mesh, device,
                           spec["batches"][:2], tp=True, sp=True)
    return {"params": full_params(mesh, state.params), "metrics": metrics}


def halo_conv_run(spec, mesh, device):
    """conv1d_apply of each of spec["halo_convs"] (kw, dilation, causal) on
    the whole x of spec["halo_x"] (mesh None) or on this rank's block of its
    `halo_groups` inside sequence_parallel: the outputs and the gradients of
    x and of the weights against the cotangent spec["halo_dy"]."""
    x_all = torch.as_tensor(spec["halo_x"]).to(device)
    dy_all = torch.as_tensor(spec["halo_dy"]).to(device)
    groups = spec["halo_groups"]
    ctx, rows = contextlib.nullcontext(), slice(None)
    if mesh is not None:
        m = mesh_lib.axis_rank(mesh, mesh_lib.MODEL_AXIS)
        per = x_all.shape[1] // sum(groups)
        rows = slice(sum(groups[:m]) * per, sum(groups[:m + 1]) * per)
        ctx = core.sequence_parallel(
            mesh_lib.axis_group(mesh, mesh_lib.MODEL_AXIS), groups)
    out = []
    for i, (kw, dil, causal) in enumerate(spec["halo_convs"]):
        p = {k: torch.as_tensor(v).to(device).requires_grad_(True)
             for k, v in spec["halo_params"][i].items()}
        x = x_all[:, rows].clone().requires_grad_(True)
        with ctx, core.conv_mode("kernel"):
            y = core.conv1d_apply(p, x, dilation=dil, causal=causal)
        y.backward(dy_all[:, rows])
        grads = {k: host(v.grad) for k, v in p.items()}
        if mesh is not None:   # the weights' shares over the ranks
            for k, v in p.items():
                mesh_lib.all_reduce(v.grad, mesh_lib.axis_group(
                    mesh, mesh_lib.MODEL_AXIS))
                grads[k] = host(v.grad)
        out.append({"y": host(y), "dx": host(x.grad), "grads": grads,
                    "rows": (rows.start, rows.stop)})
    return out


def body_halo_conv(spec, mesh, device):
    mesh_lib.reset_counts()
    res = halo_conv_run(spec, mesh, device)
    return {"convs": res, "collectives": dict(mesh_lib.COUNTS)}


def body_sp4_step(spec, mesh, device):
    """One sp step over four model ranks (decoder blocks of 2 groups; the
    decoder's dilation-27 conv reaches 108 groups back)."""
    state, metrics = train(spec, mesh, device, spec["batches"][:1], tp=True,
                           sp=True)
    return {"params": full_params(mesh, state.params), "metrics": metrics}


SESSIONS = {
    "dp": (2, 1, ("dp_train", "ragged", "tts", "tts_speakers")),
    "tp": (1, 2, ("tp_forward", "tp_builders", "clip")),
    "dptp": (2, 2, ("dptp_step", "ckpt")),
    "tp_cuda": (1, 2, ("tp_forward",)),
    "dptp_nccl": (2, 2, ("dptp_step", "ckpt")),
    "sp": (2, 2, ("sp_step", "sp_ragged", "sp_builders")),
    "sp4": (1, 4, ("halo_conv", "sp4_step", "sp_dropout")),
    "sp_nccl": (1, 2, ("sp_step",)),
}


def spawn(session, spec, work, timeout=300):
    """Run a session's ranks, each a process of this file, in the
    directory `work` (a pathlib.Path); returns what they found, rank by
    rank. A rank that fails fails the caller with its output."""
    world = SESSIONS[session][0] * SESSIONS[session][1]
    with open(work / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), session, str(r),
         str(world), str(work / "init"), str(work / "spec.pkl"), str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, "rank %d of %s failed:\n%s" % (
            r, session, log[-4000:])
    out = []
    for r in range(world):
        with open(work / ("rank%d.pkl" % r), "rb") as f:
            out.append(pickle.load(f))
    assert not any(o["jax_imported"] for o in out)
    return out


def run(session, spec, mesh, device):
    with core.strict_numerics():
        return {name: globals()["body_" + name](spec, mesh, device)
                for name in SESSIONS[session][2]}


def main():
    session, rank, world, init_file, spec_path, out_dir = sys.argv[1:]
    rank, world = int(rank), int(world)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    backend = spec.get("backend", "gloo")
    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":  # NCCL: card RANK; gloo: the ranks share card 0
        device = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="file://" + init_file,
                            rank=rank, world_size=world)
    n_data, n_model, _ = SESSIONS[session]
    mesh = mesh_lib.make_mesh(n_data, n_model, device=device)
    out = run(session, spec, mesh, device)
    out["collectives"] = dict(mesh_lib.COUNTS)
    out["jax_imported"] = any(m == "jax" or m.startswith(
        "deepvoice3_pytorch_tpu.") for m in sys.modules)
    with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
