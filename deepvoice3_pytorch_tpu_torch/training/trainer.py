# coding: utf-8
"""Train state and train step, counterpart of
deepvoice3_pytorch_tpu/training/trainer.py.

One call of the step runs the teacher-forced forward (seq2seq and/or
postnet), every loss (masked L1, binary divergence, done BCE, guided
attention), the backward, the gradient mask, the global-norm clip and the
Adam update with the learning-rate schedule, all on the device that holds
the parameters. The optimizer is written out as tensor code so that it
reproduces optax's `chain(add_decayed_weights?, clip_by_global_norm, adam)`
exactly: the clip scales by max_norm / g_norm only when g_norm >= max_norm,
the learning rate of update k (from 0) is lr_fn(k), Adam's bias correction
uses k + 1, and `grad_norm` is taken after the mask and before the clip.
`hparams.amsgrad` swaps adam for optax's amsgrad (`scale_by_amsgrad`: the
running maximum of the bias-corrected second moment in the denominator).
(`torch.nn.utils.clip_grad_norm_` and `torch.optim.Adam` with `LambdaLR`
differ in the norm's epsilon and the step index.)

Unlike the JAX step, which returns new immutable arrays, the step updates the
master parameters and the Adam moments in place, which saves a copy of each.

On CUDA the step's kw > 1 convolutions run kernel B3 (`conv_mode="kernel"`,
the default); `conv_mode="library"` runs them through F.conv1d.

On a mesh (`make_train_step(..., mesh=)`, parallel/mesh.py) each rank takes
its rows of the global batch; the losses are its shares of the global
batch's (losses.data_shard), and the gradients and the metrics are summed
over "data" in one flat buffer, so every rank applies the same update to the
same parameters. With tensor parallelism (a tree that `shard_params` sliced)
the forward runs inside core.tensor_parallel, and the clip and `grad_norm`
count the sliced leaves' squares over "model" once. With sequence
parallelism (`seq_sharding=`) each rank also takes its block of frames;
the sliced leaves are gathered whole for the forward and their gradients
summed over the mesh before each rank keeps its blocks, so the storage, the
moments and the clip's norm stay tp's.
"""

import contextlib
from typing import Any, NamedTuple, Optional

import torch

from ..builder import TTSModelConfig, model_forward
from ..ops import core
from ..parallel import mesh as mesh_lib
from ..params import nest
from . import losses
from . import lrschedule as lrs


class TrainState(NamedTuple):
    params: Any       # params.ParamTree of f32 masters, requires_grad set
    opt_state: Any    # AdamState
    step: int


class AdamState(NamedTuple):
    count: int        # updates applied so far (optax's count)
    mu: Any           # dotted name -> first moment
    nu: Any           # dotted name -> second moment
    # the optax transforms chained before adam, whose states hold no
    # leaves ("add_decayed_weights", "clip_by_global_norm"): a checkpoint's
    # optimizer fingerprint names them (training/checkpoint.py)
    transforms: tuple = ()
    # amsgrad: dotted name -> the running maximum of the bias-corrected
    # second moment (optax's ScaleByAmsgradState.nu_max); None for adam
    nu_max: Any = None


class LossConfig(NamedTuple):
    r: int
    downsample_step: int
    masked_loss_weight: float = 0.5
    binary_divergence_weight: float = 0.1
    priority_bin: Optional[int] = None
    priority_freq_weight: float = 0.0
    use_guided_attention: bool = True
    guided_attention_sigma: float = 0.2
    train_seq2seq: bool = True
    train_postnet: bool = True


def loss_config_from_hparams(hp):
    linear_dim = hp.fft_size // 2 + 1
    return LossConfig(
        r=hp.outputs_per_step,
        downsample_step=hp.downsample_step,
        masked_loss_weight=hp.masked_loss_weight,
        binary_divergence_weight=hp.binary_divergence_weight,
        priority_bin=int(hp.priority_freq / (hp.sample_rate * 0.5)
                         * linear_dim),
        priority_freq_weight=hp.priority_freq_weight,
        use_guided_attention=hp.use_guided_attention,
        guided_attention_sigma=hp.guided_attention_sigma,
    )


def make_lr_fn(hp):
    if hp.lr_schedule is None or hp.lr_schedule == "":
        return lambda step: torch.tensor(hp.initial_learning_rate,
                                         dtype=torch.float32)
    return lrs.get_schedule(hp.lr_schedule, hp.initial_learning_rate,
                            **dict(hp.lr_schedule_kwargs))


class Optimizer(NamedTuple):
    """optax.chain(add_decayed_weights(weight_decay) if > 0,
    clip_by_global_norm(clip_thresh) if > 0, adam(lr_fn, b1, b2, eps)), or
    amsgrad(lr_fn, b1, b2, eps) in adam's place."""
    lr_fn: Any
    b1: float
    b2: float
    eps: float
    clip_thresh: float = 0.0
    weight_decay: float = 0.0
    amsgrad: bool = False

    def init(self, params):
        """params: dotted name -> tensor."""
        transforms = (("add_decayed_weights",) if self.weight_decay > 0
                      else ()) + (("clip_by_global_norm",)
                                  if self.clip_thresh > 0 else ())
        def zeros():
            return {k: torch.zeros_like(v) for k, v in params.items()}

        return AdamState(0, zeros(), zeros(), transforms,
                         zeros() if self.amsgrad else None)

    def apply(self, params, grads, state, norm_fn=None):
        """Update `params` and the moments in place from `grads` (dotted
        name -> tensor; names missing from grads have a zero gradient).
        norm_fn(names, tensors): the clip's global norm (global_norm's by
        default; the tensor-parallel norm on a mesh). Returns the new
        AdamState."""
        names = list(params) if self.weight_decay > 0 else list(grads)
        if not names:
            return state._replace(count=state.count + 1)
        p = [params[k] for k in names]
        g = [grads[k] if k in grads else torch.zeros_like(params[k])
             for k in names]
        if self.weight_decay > 0:
            g = torch._foreach_add(g, torch._foreach_mul(p,
                                                         self.weight_decay))
        if self.clip_thresh > 0:
            # (g / g_norm) * max_norm when g_norm >= max_norm, else g; the
            # untriggered branch divides and multiplies by 1, which is exact
            g_norm = (global_norm(g) if norm_fn is None
                      else norm_fn(names, g))
            keep = g_norm < self.clip_thresh
            one = torch.ones_like(g_norm)
            g = torch._foreach_div(g, torch.where(keep, one, g_norm))
            g = torch._foreach_mul(g, torch.where(
                keep, one, torch.full_like(g_norm, self.clip_thresh)))
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - self.b2))
        count_inc = state.count + 1
        bc1 = float(1.0 - torch.tensor(self.b1) ** count_inc)
        bc2 = float(1.0 - torch.tensor(self.b2) ** count_inc)
        nu_hat = torch._foreach_div(nu, bc2)
        if self.amsgrad:
            # optax's scale_by_amsgrad: nu_max = max(nu_max, nu_hat), and
            # the update divides by sqrt(nu_max) + eps
            nu_max = [state.nu_max[k] for k in names]
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        lr = float(self.lr_fn(state.count))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)
        return state._replace(count=count_inc)


def make_optimizer(hp, lr_fn):
    """Adam(beta1, beta2, eps), or AMSGrad with hp.amsgrad, with the
    global-norm clip and optional weight decay."""
    return Optimizer(lr_fn, hp.adam_beta1, hp.adam_beta2, hp.adam_eps,
                     clip_thresh=hp.clip_thresh,
                     weight_decay=getattr(hp, "weight_decay", 0.0),
                     amsgrad=bool(getattr(hp, "amsgrad", False)))


def global_norm(tensors):
    """sqrt of the sum of squares of every element, as a 0-d f32 tensor."""
    norms = torch._foreach_norm(list(tensors))
    return torch.linalg.vector_norm(torch.stack(norms))


def trainable_mask(params, cfg: TTSModelConfig, *, train_seq2seq=True,
                   train_postnet=True):
    """Dotted name -> 1.0 (trained) or 0.0 (frozen): the positional tables
    unless trainable, the text embedding when frozen, and the halves that a
    partial seq2seq / postnet run leaves alone."""
    mask = {}
    for name in params.state_dict():
        top = name.split(".")[0]
        frozen = (
            (not cfg.trainable_positional_encodings
             and name.startswith(("decoder.embed_query_positions.",
                                  "decoder.embed_keys_positions.")))
            or (cfg.freeze_embedding
                and name.startswith("encoder.embed_tokens."))
            or (not train_seq2seq and top in ("encoder", "decoder"))
            or (not train_postnet and top == "converter"))
        mask[name] = 0.0 if frozen else 1.0
    return mask


def _targets(target, following, r, sp):
    """The target frames t + r of the outputs that have one: (those
    targets, the global index of the first, their global count); the
    outputs they go with are the first as many of the block's. Under sp (a
    core.sequence_parallel) the block's targets run on into `following`,
    the r frames after the block."""
    if sp is None:
        return target[:, r:], r, target.shape[1] - r
    _, start, total = sp.blocks(target.shape[1])
    n = max(0, min(start + target.shape[1], total - r) - start)
    return (torch.cat([target[:, r:], following], dim=1)[:, :n], start + r,
            total - r)


def _frame_mask(lengths, first, n):
    """(B, n, 1) f32: 1 where global frame first + i < lengths[b]."""
    pos = torch.arange(first, first + n, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).float()[..., None]


def compute_losses(outputs, batch, lc: LossConfig, sp=None):
    """The loss blend. batch: x, input_lengths, mel (downsampled), y
    (linear), text_positions, frame_positions, done, target_lengths.

    The masks follow the reference's train loop, including its
    downsample_step == 1 quirk: the decoder-domain mask (valid length
    target_lengths // r) is reused for the linear loss when no downsampling
    is in effect.

    sp: the step's core.sequence_parallel, whose blocks of frames `outputs`
    and the frame entries of `batch` are (mesh.shard_batch(sp=True)); the
    losses are then this block's shares (losses.data_shard(sp=True))."""
    mel_outputs, linear_outputs, attn, done_hat = outputs
    r = lc.r
    mel = batch["mel"]
    y = batch["y"]
    w = lc.binary_divergence_weight

    target_lengths = batch["target_lengths"]
    decoder_lengths = target_lengths // (r * lc.downsample_step)
    nexts = ({k: batch[n] for k, n in mesh_lib.NEXT_KEYS.items()}
             if sp is not None else {})

    metrics = {}
    loss = 0.0

    mel_t, mel_first, mel_frames = _targets(mel, nexts.get("mel"), r, sp)
    y_t, lin_first, lin_frames = _targets(y, nexts.get("y"), r, sp)
    if lc.masked_loss_weight > 0:
        decoder_target_mask = _frame_mask(decoder_lengths, mel_first,
                                          mel_t.shape[1])
        if lc.downsample_step > 1:
            target_mask = _frame_mask(target_lengths, lin_first,
                                      y_t.shape[1])
        else:
            target_mask = decoder_target_mask
        losses.prime_masks(decoder_target_mask, target_mask)
    else:
        decoder_target_mask, target_mask = None, None

    if lc.train_seq2seq:
        with losses.global_frames(mel_frames):
            mel_l1, mel_bd = losses.spec_loss(
                mel_outputs[:, :mel_t.shape[1]], mel_t, decoder_target_mask,
                masked_loss_weight=lc.masked_loss_weight,
                binary_divergence_weight=lc.binary_divergence_weight)
        mel_loss = (1 - w) * mel_l1 + w * mel_bd
        if sp is None:
            t_start, n_dec = 0, done_hat.shape[1]
        else:
            _, t_start, n_dec = sp.blocks(done_hat.shape[1])
        with losses.global_frames(n_dec):
            done_loss = losses.bce_loss(done_hat, batch["done"])
        loss = loss + mel_loss + done_loss
        metrics.update(mel_l1_loss=mel_l1, mel_binary_div_loss=mel_bd,
                       mel_loss=mel_loss, done_loss=done_loss)
        if lc.use_guided_attention:
            with losses.global_frames(n_dec):
                attn_loss = losses.guided_attention_loss(
                    attn, batch["input_lengths"], decoder_lengths,
                    g=lc.guided_attention_sigma, t_start=t_start)
            loss = loss + attn_loss
            metrics["attn_loss"] = attn_loss

    if lc.train_postnet:
        with losses.global_frames(lin_frames):
            lin_l1, lin_bd = losses.spec_loss(
                linear_outputs[:, :y_t.shape[1]], y_t, target_mask,
                masked_loss_weight=lc.masked_loss_weight,
                binary_divergence_weight=lc.binary_divergence_weight,
                priority_bin=lc.priority_bin,
                priority_w=lc.priority_freq_weight)
        linear_loss = (1 - w) * lin_l1 + w * lin_bd
        loss = loss + linear_loss
        metrics.update(linear_l1_loss=lin_l1, linear_binary_div_loss=lin_bd,
                       linear_loss=linear_loss)

    metrics["loss"] = loss
    return loss, metrics


def make_train_step(cfg: TTSModelConfig, lc: LossConfig, optimizer, mask,
                    compute_dtype=torch.float32, conv_mode="kernel",
                    mesh=None, seq_sharding=None):
    """Build the train step: `step(state, batch, generator) -> (state,
    metrics)`.

    batch: dict of tensors on the parameters' device (`batch_to`);
    generator: a torch.Generator on that device, drawn from for dropout.
    metrics: dict of 0-d tensors (no host synchronisation inside the step).

    compute_dtype=torch.bfloat16 is the mixed-precision path: the f32 master
    parameters and the decoder input `mel_in` are cast explicitly to bf16
    inside the differentiated function (so the gradients reach the masters
    in f32), the forward and backward run in bf16 (attention scores and
    softmax in f32), and the outputs are cast back to f32 for the losses
    against the untouched f32 targets. Adam's moments stay f32.

    conv_mode: "kernel" runs every kw > 1 conv through kernel B3 (its plain
    version for CPU tensors); "library" through F.conv1d.

    mesh: a parallel.mesh DeviceMesh; batch is then this rank's rows of the
    global batch (mesh.shard_batch), the parameters those `shard_params`
    placed, and the metrics are the global batch's. Without it the step
    makes no collective.

    seq_sharding (mesh.seq_sharding(mesh), with a mesh) turns on sequence
    parallelism, as the JAX step's argument: batch is this rank's block of
    frames as well (mesh.shard_batch(sp=True)), the forward runs inside
    core.sequence_parallel (halo exchanges around every kw > 1 conv, still
    through B3 in kernel mode) on whole weights, the tp-sliced leaves
    gathered over "model" first, and the gradients and metrics, which hold
    only this rank's frames, are summed over the whole mesh before each
    rank keeps its blocks of the sliced leaves' gradients."""
    compute_dtype = getattr(torch, compute_dtype) \
        if isinstance(compute_dtype, str) else compute_dtype
    if conv_mode not in core.CONV_MODES:
        raise ValueError("conv_mode must be one of %s" % (core.CONV_MODES,))
    if seq_sharding is not None and mesh is None:
        raise ValueError("seq_sharding needs the mesh")
    cast = compute_dtype != torch.float32

    def loss_fn(leaves, batch, generator, sliced, sp):
        tree = {k: v.to(compute_dtype) if cast and v.dtype == torch.float32
                else v for k, v in leaves.items()}
        with tp_block([tree[k] for k in sliced]):
            return forward_losses(nest(tree), batch, generator, sp)

    def tp_block(sharded):
        if not sharded:
            return contextlib.nullcontext()
        return core.tensor_parallel(
            mesh_lib.axis_group(mesh, mesh_lib.MODEL_AXIS), sharded)

    def forward_losses(params, batch, generator, sp):
        mel_in = batch["mel"].to(compute_dtype) if cast else batch["mel"]
        with sp or contextlib.nullcontext():
            if lc.train_seq2seq:
                outputs = model_forward(
                    params, cfg, batch["x"], mel_in,
                    speaker_ids=batch.get("speaker_ids"),
                    text_positions=batch["text_positions"],
                    frame_positions=batch["frame_positions"],
                    input_lengths=batch["input_lengths"],
                    training=True, generator=generator)
                if not lc.train_postnet:
                    outputs = (outputs[0], None, outputs[2], outputs[3])
            else:
                linear = cfg.family.converter_apply(
                    params["converter"], cfg.converter, mel_in,
                    training=True, generator=generator)
                outputs = (None, linear, None, None)
        if cast:
            outputs = tuple(None if o is None else o.float()
                            for o in outputs)
        return compute_losses(outputs, batch, lc, sp)

    def train_step(state: TrainState, batch, generator):
        leaves = dict(state.params.named_parameters())
        trained = [k for k, v in leaves.items() if mask[k] and
                   v.requires_grad]
        layout = mesh_lib.layout_of(state.params) if mesh is not None \
            else None
        sliced = layout.axes if layout is not None else {}
        sp = None
        if seq_sharding is not None:
            sp = core.sequence_parallel(
                mesh_lib.axis_group(mesh, mesh_lib.MODEL_AXIS),
                batch[mesh_lib.FRAME_GROUPS])
            if sliced:        # whole weights for the forward (ZeRO-3 style)
                whole = mesh_lib.gather_sliced(mesh, leaves, layout)
                leaves = dict(leaves, **{
                    k: v.requires_grad_(leaves[k].requires_grad)
                    for k, v in whole.items()})
        with core.conv_mode(conv_mode), \
                losses.data_shard(mesh, sp=sp is not None):
            loss, metrics = loss_fn(leaves, batch, generator,
                                    {} if sp is not None else sliced, sp)
        grads = torch.autograd.grad(loss, [leaves[k] for k in trained],
                                    allow_unused=True)
        grads = {k: g for k, g in zip(trained, grads) if g is not None}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            # one flat all-reduce over "data" (the whole mesh under sp):
            # the gradients, and the metrics (each rank's share of the
            # global batch's value)
            mesh_lib.reduce_over_data(mesh, list(grads.values()) + [
                v.reshape(1) for v in metrics.values()],
                whole_mesh=sp is not None)
        if sp is not None and sliced:
            grads = {k: mesh_lib.own_block(layout, k, g).contiguous()
                     for k, g in grads.items()}
            leaves = dict(state.params.named_parameters())
        norm_fn = None
        if sliced:
            def norm_fn(names, tensors):
                return mesh_lib.tp_global_norm(
                    mesh, [k in sliced for k in names], tensors)
        metrics["grad_norm"] = (
            torch.zeros(()) if not grads
            else global_norm(grads.values()) if norm_fn is None
            else norm_fn(list(grads), list(grads.values())))
        with torch.no_grad():
            opt_state = optimizer.apply(leaves, grads, state.opt_state,
                                        norm_fn)
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return train_step


def init_train_state(params, optimizer):
    """TrainState over `params` (a ParamTree; it stays on its device, and is
    updated in place by the step): gradients are switched on for every
    parameter and the Adam moments start at zero beside them."""
    for p in params.parameters():
        p.requires_grad_(True)
    leaves = {k: v.detach() for k, v in params.named_parameters()}
    return TrainState(params, optimizer.init(leaves), 0)


def batch_to(batch, device):
    """numpy batch (collate's output) -> tensors on `device`: ints as int64,
    floats as f32; a sp batch's `frame_groups` stays a tuple on the host."""
    out = {}
    for k, v in batch.items():
        if k == mesh_lib.FRAME_GROUPS:
            out[k] = tuple(v)
            continue
        t = torch.as_tensor(v)
        t = t.long() if not t.is_floating_point() else t.float()
        out[k] = t.to(device)
    return out
