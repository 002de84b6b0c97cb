# coding: utf-8
"""Model builders (deepvoice3, nyanko, deepvoice3_multispeaker), the
teacher-forced forward and the inference halves, counterpart of
deepvoice3_pytorch_tpu/builder.py. A multi-speaker model takes
`speaker_ids` (B,) wherever the JAX package does."""

from dataclasses import dataclass

from .models import deepvoice3 as dv3
from .models import nyanko as nk
from .ops import core
from .params import model_init  # noqa: F401  (re-export)
from .utils import profiling


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
        return nk if self.builder == "nyanko" else dv3

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


def nyanko(n_vocab, embed_dim=128, mel_dim=80, linear_dim=513, r=1,
           downsample_step=4,
           n_speakers=1, speaker_embed_dim=16, padding_idx=0,
           dropout=(1 - 0.95), kernel_size=3,
           encoder_channels=256,
           decoder_channels=256,
           converter_channels=512,
           query_position_rate=1.0,
           key_position_rate=1.29,
           use_memory_mask=False,
           trainable_positional_encodings=False,
           force_monotonic_attention=True,
           use_decoder_state_for_postnet_input=False,
           max_positions=512, embedding_weight_std=0.01,
           speaker_embedding_weight_std=0.01,
           freeze_embedding=False,
           window_ahead=3,
           window_backward=1,
           key_projection=False,
           value_projection=False,
           ):
    """Nyanko/DCTTS (reference builder.py:96-169). Single-speaker, r = 1,
    downsample_step = 4 only."""
    if encoder_channels != decoder_channels:
        raise ValueError("nyanko needs encoder_channels == decoder_channels")
    if n_speakers != 1:
        raise ValueError("Multi-speaker is not supported")
    if not (downsample_step == 4 and r == 1):
        raise ValueError(
            "Not supported. You need to change hardcoded parameters")

    encoder = nk.NyankoEncoderConfig(
        n_vocab=n_vocab, embed_dim=embed_dim, channels=encoder_channels,
        kernel_size=kernel_size, padding_idx=padding_idx,
        embedding_weight_std=embedding_weight_std, dropout=dropout)

    decoder = nk.NyankoDecoderConfig(
        embed_dim=embed_dim, in_dim=mel_dim, r=r, channels=decoder_channels,
        kernel_size=kernel_size, max_positions=max_positions,
        padding_idx=padding_idx, dropout=dropout,
        use_memory_mask=use_memory_mask,
        force_monotonic_attention=bool(force_monotonic_attention),
        query_position_rate=query_position_rate,
        key_position_rate=key_position_rate,
        window_ahead=window_ahead, window_backward=window_backward,
        key_projection=key_projection, value_projection=value_projection,
        trainable_positional_encodings=trainable_positional_encodings)

    in_dim = decoder_channels // r if use_decoder_state_for_postnet_input \
        else mel_dim
    converter = nk.NyankoConverterConfig(
        in_dim=in_dim, out_dim=linear_dim, channels=converter_channels,
        kernel_size=kernel_size, dropout=dropout)

    return TTSModelConfig(
        builder="nyanko", encoder=encoder, decoder=decoder,
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


def embed_speakers(params, cfg: TTSModelConfig, speaker_ids):
    """(B,) speaker ids -> (B, speaker_embed_dim) embeddings, or None.
    Raises for ids given to a single-speaker model."""
    if speaker_ids is None:
        return None
    if cfg.n_speakers <= 1:
        raise ValueError("speaker_ids given to a single-speaker model (%s)"
                         % cfg.builder)
    return core.embedding_apply(params["embed_speakers"], speaker_ids)


def model_forward(params, cfg: TTSModelConfig, text_sequences, mel_targets, *,
                  speaker_ids=None, text_positions=None, frame_positions=None,
                  input_lengths=None, training=False, generator=None):
    """Teacher-forced full-model forward.

    Returns (mel_outputs (B, T, mel), linear_outputs (B, T', linear),
    alignments (n_att, B, T/r, T_k), done (B, T/r, 1))."""
    fam = cfg.family
    B = text_sequences.shape[0]
    speaker_embed = embed_speakers(params, cfg, speaker_ids)
    with core.whole_sequence():     # the text is whole under sp too
        encoder_out = fam.encoder_apply(params["encoder"], cfg.encoder,
                                        text_sequences,
                                        speaker_embed=speaker_embed,
                                        training=training,
                                        generator=generator)
    mel_outputs, alignments, done, decoder_states = fam.decoder_apply(
        params["decoder"], cfg.decoder, encoder_out, mel_targets,
        text_positions=text_positions, frame_positions=frame_positions,
        speaker_embed=speaker_embed, lengths=input_lengths,
        training=training, generator=generator)
    mel_outputs = mel_outputs.reshape(B, -1, cfg.mel_dim)
    if cfg.use_decoder_state_for_postnet_input:
        postnet_inputs = decoder_states.reshape(B, mel_outputs.shape[1], -1)
    else:
        postnet_inputs = mel_outputs
    linear_outputs = fam.converter_apply(
        params["converter"], cfg.converter, postnet_inputs,
        speaker_embed=speaker_embed, training=training, generator=generator)
    return mel_outputs, linear_outputs, alignments, done


def model_decode(params, cfg: TTSModelConfig, text_sequences,
                 text_positions, *, speaker_ids=None, input_lengths=None,
                 max_decoder_steps=None, early_exit=True, test_inputs=None):
    """Encoder + greedy autoregressive decode (no postnet); with
    test_inputs (B, T/r, mel * r), teacher-forced over its frames.

    Returns (mel_outputs (B,T,mel), postnet_inputs (B,T,·), alignments,
    done (B,T/r), lengths (B,))."""
    fam = cfg.family
    B = text_sequences.shape[0]
    with profiling.span("dv3.encoder", "device"):
        speaker_embed = embed_speakers(params, cfg, speaker_ids)
        encoder_out = fam.encoder_apply(params["encoder"], cfg.encoder,
                                        text_sequences,
                                        speaker_embed=speaker_embed)
    with profiling.span("dv3.decode", "device"):
        out = fam.decoder_decode(
            params["decoder"], cfg.decoder, encoder_out, text_positions,
            speaker_embed=speaker_embed, lengths=input_lengths,
            max_decoder_steps=max_decoder_steps, early_exit=early_exit,
            test_inputs=test_inputs)
    mel_outputs = out.outputs.reshape(B, -1, cfg.mel_dim)
    if cfg.use_decoder_state_for_postnet_input:
        postnet_inputs = out.decoder_states.reshape(
            B, mel_outputs.shape[1], -1)
    else:
        postnet_inputs = mel_outputs
    return (mel_outputs, postnet_inputs, out.alignments, out.done,
            out.lengths)


def model_postnet(params, cfg: TTSModelConfig, postnet_inputs, *,
                  speaker_ids=None):
    """Converter half of synthesis: postnet inputs -> linear spectrogram."""
    return cfg.family.converter_apply(
        params["converter"], cfg.converter, postnet_inputs,
        speaker_embed=embed_speakers(params, cfg, speaker_ids))


def model_synthesize(params, cfg: TTSModelConfig, text_sequences,
                     text_positions, *, speaker_ids=None, input_lengths=None,
                     max_decoder_steps=None, early_exit=True,
                     test_inputs=None):
    """Greedy autoregressive synthesis: model_decode, then model_postnet on
    every decoded frame (no trim to the lengths).

    Returns (mel_outputs, linear_outputs, alignments (B,T/r,T_k),
    done (B,T/r), lengths (B,))."""
    mel_outputs, postnet_inputs, alignments, done, lengths = model_decode(
        params, cfg, text_sequences, text_positions,
        speaker_ids=speaker_ids, input_lengths=input_lengths,
        max_decoder_steps=max_decoder_steps, early_exit=early_exit,
        test_inputs=test_inputs)
    linear_outputs = model_postnet(params, cfg, postnet_inputs,
                                   speaker_ids=speaker_ids)
    return mel_outputs, linear_outputs, alignments, done, lengths
