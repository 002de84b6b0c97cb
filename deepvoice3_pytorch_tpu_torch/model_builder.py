# coding: utf-8
"""hparams -> model config/params glue, counterpart of
deepvoice3_pytorch_tpu/model_builder.py."""

import torch

from . import builder as builder_mod


def build_config(hp, n_vocab):
    """Map the hparams surface onto a builder call."""
    build_fn = getattr(builder_mod, hp.builder, None)
    if build_fn is None:
        raise ValueError("unknown builder %r" % hp.builder)
    return build_fn(
        n_speakers=hp.n_speakers,
        speaker_embed_dim=hp.speaker_embed_dim,
        n_vocab=n_vocab,
        embed_dim=hp.text_embed_dim,
        mel_dim=hp.num_mels,
        linear_dim=hp.fft_size // 2 + 1,
        r=hp.outputs_per_step,
        downsample_step=hp.downsample_step,
        padding_idx=hp.padding_idx,
        dropout=hp.dropout,
        kernel_size=hp.kernel_size,
        encoder_channels=hp.encoder_channels,
        decoder_channels=hp.decoder_channels,
        converter_channels=hp.converter_channels,
        query_position_rate=hp.query_position_rate,
        key_position_rate=hp.key_position_rate,
        use_memory_mask=hp.use_memory_mask,
        trainable_positional_encodings=hp.trainable_positional_encodings,
        force_monotonic_attention=hp.force_monotonic_attention,
        use_decoder_state_for_postnet_input=(
            hp.use_decoder_state_for_postnet_input),
        max_positions=hp.max_positions,
        embedding_weight_std=hp.embedding_weight_std,
        speaker_embedding_weight_std=hp.speaker_embedding_weight_std,
        freeze_embedding=hp.freeze_embedding,
        window_ahead=hp.window_ahead,
        window_backward=hp.window_backward,
        key_projection=hp.key_projection,
        value_projection=hp.value_projection,
    )


def build_model(hp, n_vocab, seed=1234, device="cuda"):
    """(cfg, params) with random params drawn from a CPU generator seeded
    with `seed`, then moved to `device` (the card unless the caller asks
    for the CPU)."""
    cfg = build_config(hp, n_vocab)
    params = builder_mod.model_init(cfg, torch.Generator().manual_seed(seed),
                                    device)
    return cfg, params
