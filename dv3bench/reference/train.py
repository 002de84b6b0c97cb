# coding: utf-8
"""The plain reference of the train step: the teacher-forced forward, the
loss blend, the backward by autograd, the gradient mask, the global-norm
clip and Adam with the learning-rate schedule, in one process. A frozen
copy of the port's plain versions (deepvoice3_pytorch_tpu_torch/training/
trainer.py: compute_losses, trainable_mask, Optimizer.apply; builder.py:
model_forward) without meshes, bf16 or kernels. Dropout draws from a
`torch.Generator` in the port's order, so a generator seeded alike gives
the same masks."""

import torch

from . import core
from . import losses
from . import lrschedule as lrs


def model_forward(tree, cfg, batch, generator):
    fam_enc, fam = cfg.encoder, cfg.family
    x = batch["x"]
    B = x.shape[0]
    se = None
    if batch.get("speaker_ids") is not None:
        se = core.embedding_apply(tree["embed_speakers"],
                                  batch["speaker_ids"])
    enc = fam.encoder_apply(tree["encoder"], fam_enc, x, speaker_embed=se,
                            training=True, generator=generator)
    mel, align, done, states = fam.decoder_apply(
        tree["decoder"], cfg.decoder, enc, batch["mel"],
        text_positions=batch["text_positions"],
        frame_positions=batch["frame_positions"], speaker_embed=se,
        lengths=batch["input_lengths"], training=True, generator=generator)
    mel = mel.reshape(B, -1, cfg.mel_dim)
    post_in = (states.reshape(B, mel.shape[1], -1)
               if cfg.use_decoder_state_for_postnet_input else mel)
    linear = fam.converter_apply(tree["converter"], cfg.converter, post_in,
                                 speaker_embed=se, training=True,
                                 generator=generator)
    return mel, linear, align, done


def _frame_mask(lengths, first, n):
    pos = torch.arange(first, first + n, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).float()[..., None]


def compute_losses(outputs, batch, hp):
    mel_outputs, linear_outputs, attn, done_hat = outputs
    r, ds = hp["outputs_per_step"], hp["downsample_step"]
    w = hp["binary_divergence_weight"]
    linear_dim = hp["fft_size"] // 2 + 1
    priority_bin = int(hp["priority_freq"] / (hp["sample_rate"] * 0.5)
                       * linear_dim)
    mel, y = batch["mel"], batch["y"]
    decoder_lengths = batch["target_lengths"] // (r * ds)
    mel_t, y_t = mel[:, r:], y[:, r:]
    decoder_target_mask = _frame_mask(decoder_lengths, r, mel_t.shape[1])
    target_mask = (_frame_mask(batch["target_lengths"], r, y_t.shape[1])
                   if ds > 1 else decoder_target_mask)
    mel_l1, mel_bd = losses.spec_loss(
        mel_outputs[:, :mel_t.shape[1]], mel_t, decoder_target_mask,
        masked_loss_weight=hp["masked_loss_weight"],
        binary_divergence_weight=w)
    loss = (1 - w) * mel_l1 + w * mel_bd
    loss = loss + losses.bce_loss(done_hat, batch["done"])
    if hp["use_guided_attention"]:
        loss = loss + losses.guided_attention_loss(
            attn, batch["input_lengths"], decoder_lengths,
            g=hp["guided_attention_sigma"], t_start=0)
    lin_l1, lin_bd = losses.spec_loss(
        linear_outputs[:, :y_t.shape[1]], y_t, target_mask,
        masked_loss_weight=hp["masked_loss_weight"],
        binary_divergence_weight=w, priority_bin=priority_bin,
        priority_w=hp["priority_freq_weight"])
    return loss + (1 - w) * lin_l1 + w * lin_bd


def trained(name, cfg):
    """False for the leaves the step leaves alone: the positional tables
    (not trainable in these configurations) and a frozen text embedding."""
    return not ((not cfg.trainable_positional_encodings
                 and name.startswith(("decoder.embed_query_positions.",
                                      "decoder.embed_keys_positions.")))
                or (cfg.freeze_embedding
                    and name.startswith("encoder.embed_tokens.")))


def _nest(flat):
    root = {}
    for name, t in flat.items():
        node, parts = root, name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def run_steps(flat, cfg, hp, batches, generator, n_steps):
    """`n_steps` reference steps from the leaves `flat` (dotted name ->
    f32 tensor, updated here). Returns (losses [n], the first step's
    gradient by leaf as the optimizer is given it, before the clip, the
    leaves after the last step)."""
    names = [k for k in flat if trained(k, cfg)]
    leaves = {k: v.detach().clone().requires_grad_(k in names)
              for k, v in flat.items()}
    mu = {k: torch.zeros_like(leaves[k]) for k in names}
    nu = {k: torch.zeros_like(leaves[k]) for k in names}
    b1, b2, eps = hp["adam_beta1"], hp["adam_beta2"], hp["adam_eps"]
    clip = hp["clip_thresh"]
    lr_fn = lrs.get_schedule(hp["lr_schedule"], hp["initial_learning_rate"],
                             **dict(hp["lr_schedule_kwargs"]))
    out_losses, first_grad = [], None
    for i in range(n_steps):
        loss = compute_losses(model_forward(_nest(leaves), cfg, batches[i],
                                            generator), batches[i], hp)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        g = {k: (gr if gr is not None else torch.zeros_like(leaves[k]))
             for k, gr in zip(names, grads)}
        with torch.no_grad():
            if i == 0:
                first_grad = {k: v.clone() for k, v in g.items()}
            if clip > 0:
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(v) for v in g.values()]))
                if float(norm) >= clip:
                    g = {k: v / norm * clip for k, v in g.items()}
            lr = float(lr_fn(i))
            bc1, bc2 = 1.0 - b1 ** (i + 1), 1.0 - b2 ** (i + 1)
            for k in names:
                mu[k].mul_(b1).add_(g[k] * (1.0 - b1))
                nu[k].mul_(b2).add_(g[k] * g[k] * (1.0 - b2))
                upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
                leaves[k].add_(upd * -lr)
        out_losses.append(float(loss.detach()))
    return out_losses, first_grad, {k: v.detach() for k, v in leaves.items()}
