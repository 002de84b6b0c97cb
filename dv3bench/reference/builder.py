# coding: utf-8
"""Model configurations of the two DeepVoice3 builders in plain Python: a
frozen copy of the port's builder functions (deepvoice3_pytorch_tpu_torch/
builder.py and model_builder.py), with `config_from_hparams` mapping a
configuration file's keys onto a builder call."""

from dataclasses import dataclass

from . import deepvoice3 as dv3


@dataclass(frozen=True)
class TTSModelConfig:
    builder: str
    encoder: object
    decoder: object
    converter: object
    mel_dim: int = 80
    linear_dim: int = 513
    n_speakers: int = 1
    speaker_embed_dim: int = 16
    downsample_step: int = 1
    use_decoder_state_for_postnet_input: bool = False
    speaker_embedding_weight_std: float = 0.01
    freeze_embedding: bool = False
    trainable_positional_encodings: bool = False

    @property
    def family(self):
        """Module implementing this architecture's apply functions."""
        return dv3

    @property
    def r(self):
        return self.decoder.r


def _monotonic_tuple(force_monotonic_attention, n_layers):
    if isinstance(force_monotonic_attention, bool):
        return (force_monotonic_attention,) * n_layers
    return tuple(force_monotonic_attention)


def deepvoice3(n_vocab, embed_dim=256, mel_dim=80, linear_dim=513, r=4,
               downsample_step=1,
               n_speakers=1, speaker_embed_dim=16, padding_idx=0,
               dropout=(1 - 0.95), kernel_size=5,
               encoder_channels=128,
               decoder_channels=256,
               converter_channels=256,
               query_position_rate=1.0,
               key_position_rate=1.29,
               use_memory_mask=False,
               trainable_positional_encodings=False,
               force_monotonic_attention=True,
               use_decoder_state_for_postnet_input=True,
               max_positions=512,
               embedding_weight_std=0.1,
               speaker_embedding_weight_std=0.01,
               freeze_embedding=False,
               window_ahead=3,
               window_backward=1,
               key_projection=False,
               value_projection=False,
               ):
    """DeepVoice3: 10-layer dilated encoder, 5-layer decoder with attention
    at layers [T,F,F,F,T] (reference builder.py:7-93)."""
    time_upsampling = max(downsample_step // r, 1)
    h, k = encoder_channels, kernel_size
    encoder = dv3.EncoderConfig(
        n_vocab=n_vocab, embed_dim=embed_dim, n_speakers=n_speakers,
        speaker_embed_dim=speaker_embed_dim, padding_idx=padding_idx,
        embedding_weight_std=embedding_weight_std,
        convolutions=((h, k, 1), (h, k, 3), (h, k, 9), (h, k, 27),
                      (h, k, 1), (h, k, 3), (h, k, 9), (h, k, 27),
                      (h, k, 1), (h, k, 3)),
        dropout=dropout, num_attention_layers=2)

    h = decoder_channels
    decoder = dv3.DecoderConfig(
        embed_dim=embed_dim, n_speakers=n_speakers,
        speaker_embed_dim=speaker_embed_dim, in_dim=mel_dim, r=r,
        max_positions=max_positions, padding_idx=padding_idx,
        preattention=((h, k, 1), (h, k, 3)),
        convolutions=((h, k, 1), (h, k, 3), (h, k, 9), (h, k, 27), (h, k, 1)),
        attention=(True, False, False, False, True), dropout=dropout,
        use_memory_mask=use_memory_mask,
        force_monotonic_attention=_monotonic_tuple(force_monotonic_attention,
                                                   5),
        query_position_rate=query_position_rate,
        key_position_rate=key_position_rate,
        window_ahead=window_ahead, window_backward=window_backward,
        key_projection=key_projection, value_projection=value_projection,
        trainable_positional_encodings=trainable_positional_encodings)

    in_dim = h // r if use_decoder_state_for_postnet_input else mel_dim
    h = converter_channels
    converter = dv3.ConverterConfig(
        in_dim=in_dim, out_dim=linear_dim, n_speakers=n_speakers,
        speaker_embed_dim=speaker_embed_dim,
        convolutions=((h, k, 1), (h, k, 3), (2 * h, k, 1), (2 * h, k, 3)),
        time_upsampling=time_upsampling, dropout=dropout)

    return TTSModelConfig(
        builder="deepvoice3", encoder=encoder, decoder=decoder,
        converter=converter, mel_dim=mel_dim, linear_dim=linear_dim,
        n_speakers=n_speakers, speaker_embed_dim=speaker_embed_dim,
        downsample_step=downsample_step,
        use_decoder_state_for_postnet_input=use_decoder_state_for_postnet_input,
        speaker_embedding_weight_std=speaker_embedding_weight_std,
        freeze_embedding=freeze_embedding,
        trainable_positional_encodings=trainable_positional_encodings)


def deepvoice3_multispeaker(n_vocab, embed_dim=256, mel_dim=80,
                            linear_dim=513, r=4,
                            downsample_step=1,
                            n_speakers=1, speaker_embed_dim=16, padding_idx=0,
                            dropout=(1 - 0.95), kernel_size=5,
                            encoder_channels=128,
                            decoder_channels=256,
                            converter_channels=256,
                            query_position_rate=1.0,
                            key_position_rate=1.29,
                            use_memory_mask=False,
                            trainable_positional_encodings=False,
                            force_monotonic_attention=True,
                            use_decoder_state_for_postnet_input=True,
                            max_positions=512,
                            embedding_weight_std=0.1,
                            speaker_embedding_weight_std=0.01,
                            freeze_embedding=False,
                            window_ahead=3,
                            window_backward=1,
                            key_projection=True,
                            value_projection=True,
                            ):
    """Multi-speaker DeepVoice3: attention only at decoder layer 0, key/value
    projections on (reference builder.py:172-258)."""
    time_upsampling = max(downsample_step // r, 1)
    h, k = encoder_channels, kernel_size
    encoder = dv3.EncoderConfig(
        n_vocab=n_vocab, embed_dim=embed_dim, n_speakers=n_speakers,
        speaker_embed_dim=speaker_embed_dim, padding_idx=padding_idx,
        embedding_weight_std=embedding_weight_std,
        convolutions=((h, k, 1), (h, k, 3), (h, k, 9), (h, k, 27),
                      (h, k, 1), (h, k, 3), (h, k, 9), (h, k, 27),
                      (h, k, 1), (h, k, 3)),
        dropout=dropout, num_attention_layers=1)

    h = decoder_channels
    decoder = dv3.DecoderConfig(
        embed_dim=embed_dim, n_speakers=n_speakers,
        speaker_embed_dim=speaker_embed_dim, in_dim=mel_dim, r=r,
        max_positions=max_positions, padding_idx=padding_idx,
        preattention=((h, k, 1),),
        convolutions=((h, k, 1), (h, k, 3), (h, k, 9), (h, k, 27), (h, k, 1)),
        attention=(True, False, False, False, False), dropout=dropout,
        use_memory_mask=use_memory_mask,
        force_monotonic_attention=_monotonic_tuple(force_monotonic_attention,
                                                   5),
        query_position_rate=query_position_rate,
        key_position_rate=key_position_rate,
        window_ahead=window_ahead, window_backward=window_backward,
        key_projection=key_projection, value_projection=value_projection,
        trainable_positional_encodings=trainable_positional_encodings)

    in_dim = h // r if use_decoder_state_for_postnet_input else mel_dim
    h = converter_channels
    converter = dv3.ConverterConfig(
        in_dim=in_dim, out_dim=linear_dim, n_speakers=n_speakers,
        speaker_embed_dim=speaker_embed_dim,
        convolutions=((h, k, 1), (h, k, 3), (2 * h, k, 1), (2 * h, k, 3)),
        time_upsampling=time_upsampling, dropout=dropout)

    return TTSModelConfig(
        builder="deepvoice3_multispeaker", encoder=encoder, decoder=decoder,
        converter=converter, mel_dim=mel_dim, linear_dim=linear_dim,
        n_speakers=n_speakers, speaker_embed_dim=speaker_embed_dim,
        downsample_step=downsample_step,
        use_decoder_state_for_postnet_input=use_decoder_state_for_postnet_input,
        speaker_embedding_weight_std=speaker_embedding_weight_std,
        freeze_embedding=freeze_embedding,
        trainable_positional_encodings=trainable_positional_encodings)


def config_from_hparams(hp, n_vocab):
    """A configuration file's keys (a dict) -> TTSModelConfig."""
    build_fn = {"deepvoice3": deepvoice3,
                "deepvoice3_multispeaker": deepvoice3_multispeaker}[
                    hp["builder"]]
    return build_fn(
        n_speakers=hp["n_speakers"],
        speaker_embed_dim=hp["speaker_embed_dim"],
        n_vocab=n_vocab,
        embed_dim=hp["text_embed_dim"],
        mel_dim=hp["num_mels"],
        linear_dim=hp["fft_size"] // 2 + 1,
        r=hp["outputs_per_step"],
        downsample_step=hp["downsample_step"],
        padding_idx=hp["padding_idx"],
        dropout=hp["dropout"],
        kernel_size=hp["kernel_size"],
        encoder_channels=hp["encoder_channels"],
        decoder_channels=hp["decoder_channels"],
        converter_channels=hp["converter_channels"],
        query_position_rate=hp["query_position_rate"],
        key_position_rate=hp["key_position_rate"],
        use_memory_mask=hp["use_memory_mask"],
        trainable_positional_encodings=hp["trainable_positional_encodings"],
        force_monotonic_attention=hp["force_monotonic_attention"],
        use_decoder_state_for_postnet_input=(
            hp["use_decoder_state_for_postnet_input"]),
        max_positions=hp["max_positions"],
        embedding_weight_std=hp["embedding_weight_std"],
        speaker_embedding_weight_std=hp["speaker_embedding_weight_std"],
        freeze_embedding=hp["freeze_embedding"],
        window_ahead=hp["window_ahead"],
        window_backward=hp["window_backward"],
        key_projection=hp["key_projection"],
        value_projection=hp["value_projection"],
    )
