# coding: utf-8
"""The nyanko builder (r9y9's DCTTS: Text2Mel + SSRN, Tachibana et al.,
arXiv:1710.08969) in plain float32 PyTorch, for the benchmark's reference:
its configuration (a frozen copy of the port's `nyanko()` builder), seeded
weights in the port's tree layout and init distributions, the text
encoder, the teacher-forced decoder, one decode step and its free-running
loop, and the converter. It imports nothing of the port and nothing of
JAX: the weight-normalised convolutions, the initialisers and the position
table are the reference's own frozen copies (core.py, conv_blocks.py,
positional.py); every layer of the model is written out here.

With D decoder channels, E text embedding, F mels, C converter channels
and Fd linear bins, on (B, T, channels) activations:

  * highway conv:  [a | g] = conv(x);  y = s a + (1 - s) x,  s = sigmoid(g)
    (non-causal: (k - 1) / 2 dilation frames of zeros on each side;
    causal: (k - 1) dilation on the left, so frame t sees frames <= t);
  * text encoder:  embedding E -> 1x1 (E -> 2D, ReLU) -> 1x1 (2D -> 2D)
    -> eleven non-causal highway convs at 2D (k 3, dilations 1 3 9 27 1 3
    9 27 1 1, then one at k 1) -> split into keys | values (D each);
  * audio encoder: 1x1 (F -> D, ReLU), 1x1 (D -> D, ReLU), 1x1 (D -> D),
    ten causal highway convs at D (k 3, dilations 1 3 9 27 1 3 9 27 3 3):
    Q;
  * attention, one layer: query Q + Pq[t + 1], keys K + Pk[text position],
    values V (no key or value projection); q = query Wq + bq; scores q.K
    with padded keys and, when monotonic, keys outside [l - back, l +
    ahead) of the last attended key l at -1e9; p = softmax; context =
    sqrt(Tk) sum p V (Tk the padded text length); R = (context Wo + bo +
    query) sqrt(1/2);
  * audio decoder: 1x1 over [R | Q] (2D -> D), six causal highway convs
    (dilations 1 3 9 27 1 1), three 1x1 (D -> D, ReLU): the decoder state
    h; frame = sigmoid(h Wl + bl), done = sigmoid((h Wl + bl) wf + bf);
  * converter: 1x1 (D -> C); highway C d1, d3; transposed conv (k 2,
    stride 2); highway d1, d3; transposed conv; highway d1, d3; 1x1 (C ->
    2C); highway 2C d1, d1; 1x1 (2C -> Fd); 1x1 ReLU; 1x1 ReLU; 1x1
    sigmoid, all non-causal; its input is the decoder states (the preset's
    use_decoder_state_for_postnet_input) or the mels.

Departures from the paper, each as r9y9's implementation, the JAX package
and the port define the model:
  * the causal highway conv gates as the non-causal one does (the builder
    passes no `glu`): y = s a + (1 - s) x, not the residual GLU form
    (a s + x) sqrt(1/2);
  * the attention is DeepVoice3's: query and out projections Wq, Wo, the
    sqrt(Tk) context scale and the sqrt(1/2) residual, no key or value
    projection, and a monotonic window at inference; the paper's is
    softmax(K^T Q / sqrt(d)) over the whole text;
  * the query position table Pq and the key table Pk hold finished
    sinusoidal encodings with the rates baked in, row 0 zeros (padding);
    positions past the table take its last row; Pq is indexed by the
    frames decoded so far plus one, per row.
"""

import math
from dataclasses import dataclass
from typing import Optional

import torch

from . import conv_blocks as cb
from . import core
from .params import _Draw, flatten
from .positional import position_encoding_init

SQRT_HALF = math.sqrt(0.5)
MASK_VALUE = -1.0e9


# ---------------------------------------------------------------------------
# configuration: the port's nyanko() builder, frozen
# ---------------------------------------------------------------------------


def encoder_specs(E, D, k, dropout):
    def hw(dil, kw=None):
        return cb.highway_spec(2 * D, 2 * D, kw or k, dil, False, dropout,
                               std_mul=1.0)

    return (cb.conv1x1_spec(E, 2 * D, 1.0, activation="relu"),
            cb.conv1x1_spec(2 * D, 2 * D, 2.0),
            hw(1), hw(3), hw(9), hw(27), hw(1), hw(3), hw(9), hw(27),
            hw(1), hw(1), hw(1, kw=1))


def audio_encoder_specs(F, D, k, dropout):
    def hwc(dil):
        return cb.highway_spec(D, D, k, dil, True, dropout, std_mul=1.0)

    return (cb.conv1x1_spec(F, D, 1.0, activation="relu"),
            cb.conv1x1_spec(D, D, 2.0, activation="relu"),
            cb.conv1x1_spec(D, D, 2.0),
            hwc(1), hwc(3), hwc(9), hwc(27), hwc(1), hwc(3), hwc(9), hwc(27),
            hwc(3), hwc(3))


def audio_decoder_specs(D, k, dropout):
    def hwc(dil):
        return cb.highway_spec(D, D, k, dil, True, dropout, std_mul=1.0)

    return (cb.conv1x1_spec(2 * D, D, 1.0),
            hwc(1), hwc(3), hwc(9), hwc(27), hwc(1), hwc(1),
            cb.conv1x1_spec(D, D, 1.0, activation="relu"),
            cb.conv1x1_spec(D, D, 2.0, activation="relu"),
            cb.conv1x1_spec(D, D, 2.0, activation="relu"))


def converter_specs(F, Fd, C, k, dropout):
    def hw(ch, dil):
        return cb.highway_spec(ch, ch, k, dil, False, dropout, std_mul=1.0)

    return (cb.conv1x1_spec(F, C, 1.0),
            hw(C, 1), hw(C, 3),
            cb.convT_spec(C, C, 2, 2, std_mul=1.0),
            hw(C, 1), hw(C, 3),
            cb.convT_spec(C, C, 2, 2, std_mul=1.0),
            hw(C, 1), hw(C, 3),
            cb.conv1x1_spec(C, 2 * C, 1.0),
            hw(2 * C, 1), hw(2 * C, 1),
            cb.conv1x1_spec(2 * C, Fd, 1.0),
            cb.conv1x1_spec(Fd, Fd, 1.0, activation="relu"),
            cb.conv1x1_spec(Fd, Fd, 2.0, activation="relu"),
            cb.conv1x1_spec(Fd, Fd, 2.0, activation="sigmoid"))


@dataclass(frozen=True)
class EncoderConfig:
    n_vocab: int
    embed_dim: int
    channels: int
    kernel_size: int = 3
    padding_idx: Optional[int] = 0
    embedding_weight_std: float = 0.01
    dropout: float = 0.1

    @property
    def specs(self):
        return encoder_specs(self.embed_dim, self.channels, self.kernel_size,
                             self.dropout)


@dataclass(frozen=True)
class DecoderConfig:
    embed_dim: int
    in_dim: int = 80
    r: int = 1
    channels: int = 256
    kernel_size: int = 3
    max_positions: int = 512
    dropout: float = 0.1
    use_memory_mask: bool = False
    force_monotonic_attention: bool = False
    query_position_rate: float = 1.0
    key_position_rate: float = 1.29
    window_ahead: int = 3
    window_backward: int = 1

    @property
    def audio_encoder(self):
        return audio_encoder_specs(self.in_dim * self.r, self.channels,
                                   self.kernel_size, self.dropout)

    @property
    def audio_decoder(self):
        return audio_decoder_specs(self.channels, self.kernel_size,
                                   self.dropout)


@dataclass(frozen=True)
class ConverterConfig:
    in_dim: int
    out_dim: int
    channels: int = 512
    kernel_size: int = 3
    dropout: float = 0.1
    time_upsampling: int = 4    # two transposed convs of stride 2

    @property
    def specs(self):
        return converter_specs(self.in_dim, self.out_dim, self.channels,
                               self.kernel_size, self.dropout)


@dataclass(frozen=True)
class TTSModelConfig:
    builder: str
    encoder: EncoderConfig
    decoder: DecoderConfig
    converter: ConverterConfig
    mel_dim: int = 80
    linear_dim: int = 513
    n_speakers: int = 1
    speaker_embed_dim: int = 16
    downsample_step: int = 4
    use_decoder_state_for_postnet_input: bool = False

    @property
    def r(self):
        return self.decoder.r


def nyanko(n_vocab, embed_dim=128, mel_dim=80, linear_dim=513, r=1,
           downsample_step=4, n_speakers=1, speaker_embed_dim=16,
           padding_idx=0, dropout=(1 - 0.95), kernel_size=3,
           encoder_channels=256, decoder_channels=256,
           converter_channels=512, query_position_rate=1.0,
           key_position_rate=1.29, use_memory_mask=False,
           trainable_positional_encodings=False,
           force_monotonic_attention=True,
           use_decoder_state_for_postnet_input=False, max_positions=512,
           embedding_weight_std=0.01, speaker_embedding_weight_std=0.01,
           freeze_embedding=False, window_ahead=3, window_backward=1,
           key_projection=False, value_projection=False):
    """The port's builder: single-speaker, r = 1, downsample_step = 4, no
    key or value projection; the arguments it ignores are taken and
    ignored as it does."""
    if encoder_channels != decoder_channels:
        raise ValueError("nyanko needs encoder_channels == decoder_channels")
    if n_speakers != 1:
        raise ValueError("Multi-speaker is not supported")
    if not (downsample_step == 4 and r == 1):
        raise ValueError("nyanko takes r = 1 and downsample_step = 4 only")
    if key_projection or value_projection:
        raise ValueError("this reference has no key or value projection")
    encoder = EncoderConfig(n_vocab, embed_dim, encoder_channels,
                            kernel_size, padding_idx, embedding_weight_std,
                            dropout)
    decoder = DecoderConfig(
        embed_dim=embed_dim, in_dim=mel_dim, r=r, channels=decoder_channels,
        kernel_size=kernel_size, max_positions=max_positions,
        dropout=dropout, use_memory_mask=use_memory_mask,
        force_monotonic_attention=bool(force_monotonic_attention),
        query_position_rate=query_position_rate,
        key_position_rate=key_position_rate, window_ahead=window_ahead,
        window_backward=window_backward)
    in_dim = decoder_channels // r if use_decoder_state_for_postnet_input \
        else mel_dim
    converter = ConverterConfig(in_dim, linear_dim, converter_channels,
                                kernel_size, dropout)
    return TTSModelConfig(
        "nyanko", encoder, decoder, converter, mel_dim, linear_dim,
        n_speakers, speaker_embed_dim, downsample_step,
        use_decoder_state_for_postnet_input)


def config_from_hparams(hp, n_vocab):
    """A configuration file's keys (builder `nyanko`) -> TTSModelConfig."""
    if hp["builder"] != "nyanko":
        raise ValueError("builder %r is not nyanko" % hp["builder"])
    return nyanko(
        n_vocab=n_vocab, embed_dim=hp["text_embed_dim"],
        mel_dim=hp["num_mels"], linear_dim=hp["fft_size"] // 2 + 1,
        r=hp["outputs_per_step"], downsample_step=hp["downsample_step"],
        n_speakers=hp["n_speakers"], speaker_embed_dim=hp["speaker_embed_dim"],
        padding_idx=hp["padding_idx"], dropout=hp["dropout"],
        kernel_size=hp["kernel_size"],
        encoder_channels=hp["encoder_channels"],
        decoder_channels=hp["decoder_channels"],
        converter_channels=hp["converter_channels"],
        query_position_rate=hp["query_position_rate"],
        key_position_rate=hp["key_position_rate"],
        use_memory_mask=hp["use_memory_mask"],
        force_monotonic_attention=hp["force_monotonic_attention"],
        use_decoder_state_for_postnet_input=(
            hp["use_decoder_state_for_postnet_input"]),
        max_positions=hp["max_positions"],
        embedding_weight_std=hp["embedding_weight_std"],
        window_ahead=hp["window_ahead"],
        window_backward=hp["window_backward"],
        key_projection=hp["key_projection"],
        value_projection=hp["value_projection"])


# ---------------------------------------------------------------------------
# seeded weights, in the port's tree layout
# ---------------------------------------------------------------------------


def _position_table(n, D, rate, device):
    return {"w": torch.from_numpy(position_encoding_init(
        n, D, rate, sinusoidal=True)).to(device)}


def _tree(cfg, draw):
    ec, dc, D = cfg.encoder, cfg.decoder, cfg.decoder.channels
    F = dc.in_dim * dc.r
    return {
        "encoder": {
            "embed_tokens": core.embedding_init(
                draw, ec.n_vocab, ec.embed_dim, ec.padding_idx,
                ec.embedding_weight_std),
            "layers": cb.stack_init(draw, ec.specs)},
        "decoder": {
            "embed_query_positions": _position_table(
                dc.max_positions, D, dc.query_position_rate, draw.device),
            "embed_keys_positions": _position_table(
                dc.max_positions, D, dc.key_position_rate, draw.device),
            "audio_encoder": cb.stack_init(draw, dc.audio_encoder),
            "attention": {"query_proj": core.linear_init(draw, D, D),
                          "out_proj": core.linear_init(draw, D, D)},
            "audio_decoder": cb.stack_init(draw, dc.audio_decoder),
            "last_conv": core.conv1d_init(draw, D, F, 1, std_mul=2.0),
            "fc": core.linear_init(draw, F, 1)},
        "converter": {"layers": cb.stack_init(draw, cfg.converter.specs)},
    }


def seeded_tree(cfg, seed, device, done_bias=None):
    """Nested dict of f32 tensors on `device`, every normal draw a slice of
    one `torch.randn` from a generator on the device seeded with `seed`.
    done_bias: the done projection held at weight 0 (its g) and this bias,
    so that every row decodes the steps its call asks for."""
    count = _Draw("meta")
    _tree(cfg, count)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(count.numel, generator=gen, device=device)
    tree = _tree(cfg, _Draw(device, flat))
    if done_bias is not None:
        fc = tree["decoder"]["fc"]
        fc["g"] = torch.zeros_like(fc["g"])
        fc["b"] = torch.full_like(fc["b"], float(done_bias))
    return tree


def leaf_shapes(cfg):
    """{dotted name: shape} of the configuration's parameter tree."""
    return {k: tuple(v.shape)
            for k, v in flatten(_tree(cfg, _Draw("meta"))).items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _act(x, name):
    if name == "relu":
        return torch.relu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    return x


def _gate(y, x):
    a, g = torch.chunk(y, 2, dim=-1)
    s = torch.sigmoid(g)
    return s * a + (1.0 - s) * x


def layer(p, spec, x):
    """One layer over a whole sequence (B, T, C)."""
    if spec.kind == "conv1x1":
        return _act(x @ core.conv1d_weight(p["conv"])[0] + p["conv"]["b"],
                    spec.activation)
    if spec.kind == "convT":
        return core.conv_transpose1d_apply(p["conv"], x, stride=spec.stride)
    if spec.kind != "highway" or spec.highway_glu:
        raise ValueError("nyanko has no %s layer" % spec.kind)
    y = core.conv1d_apply(p["conv"], x, dilation=spec.dilation,
                          causal=spec.causal)
    return _gate(y, x)


def stack(plist, specs, x):
    for p, s in zip(plist, specs):
        x = layer(p, s, x)
    return x


def history(spec):
    """Frames a causal highway conv keeps for its next step: the
    (k - 1) dilation before the newest (0 for a 1x1 layer)."""
    return (spec.kernel_size - 1) * spec.dilation \
        if spec.kind == "highway" else 0


def layer_step(p, spec, past, x):
    """One frame (B, C) through a layer of a causal stack, `past` (B, h, C)
    its earlier inputs oldest first. Returns (new past, output)."""
    if spec.kind == "conv1x1":
        return past, _act(x @ core.conv1d_weight(p["conv"])[0]
                          + p["conv"]["b"], spec.activation)
    if not spec.causal:
        raise ValueError("a step runs causal layers only")
    frames = torch.cat([past, x[:, None]], dim=1)     # (B, h + 1, C)
    taps = frames[:, ::spec.dilation]                  # (B, k, C), oldest first
    w = core.conv1d_weight(p["conv"])                  # (k, C, 2C)
    y = torch.einsum("bkc,kco->bo", taps, w) + p["conv"]["b"]
    return frames[:, 1:], _gate(y, x)


def stack_step(plist, specs, pasts, x):
    new = []
    for p, s, past in zip(plist, specs, pasts):
        past, x = layer_step(p, s, past, x)
        new.append(past)
    return new, x


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def encoder(tree, cfg, ids):
    """(B, Tk) ids -> keys, values, each (B, Tk, D)."""
    p = tree["encoder"]
    x = p["embed_tokens"]["w"][ids]
    x = stack(p["layers"], cfg.encoder.specs, x)
    keys, values = torch.chunk(x, 2, dim=-1)
    return keys, values


def _table_rows(table, positions):
    return table[positions.clamp(0, table.shape[0] - 1)]


def keys_with_positions(tree, keys, text_positions):
    """The keys with the key position table's rows added (position 0, the
    padding, adds row 0: zeros)."""
    return keys + _table_rows(tree["decoder"]["embed_keys_positions"]["w"],
                              text_positions)


def padding_mask(lengths, Tk):
    """(B, Tk) True where padded."""
    return torch.arange(Tk, device=lengths.device)[None, :] >= \
        lengths[:, None]


def attention(p, query, keys, values, mask, last_attended=None, back=1,
              ahead=3):
    """query (B, Tq, D) over keys / values (B, Tk, D) -> (R (B, Tq, D),
    probabilities (B, Tq, Tk))."""
    q = core.linear_apply(p["query_proj"], query)
    scores = q @ keys.transpose(1, 2)
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, :], MASK_VALUE)
    if last_attended is not None:
        idx = torch.arange(keys.shape[1], device=keys.device)[None, :]
        la = last_attended[:, None]
        out = (idx < la - back) | (idx >= la + ahead)
        scores = scores.masked_fill(out[:, None, :], MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    Tk = values.shape[1]
    context = (probs @ values) * (Tk * math.sqrt(1.0 / Tk))
    R = (core.linear_apply(p["out_proj"], context) + query) * SQRT_HALF
    return R, probs


def _head(p, h):
    """Decoder state -> (frame, done)."""
    y = h @ core.conv1d_weight(p["last_conv"])[0] + p["last_conv"]["b"]
    return torch.sigmoid(y), torch.sigmoid(core.linear_apply(p["fc"], y))


def decoder_forward(tree, cfg, keys, values, inputs, text_positions,
                    frame_positions, mask=None):
    """Teacher-forced decoder over whole sequences, no monotonic window:
    inputs (B, T, F) the frames each step reads, frame_positions (B, T)
    the query table's rows. Returns (frames (B, T, F), probabilities
    (B, T, Tk), done (B, T, 1), decoder states (B, T, D))."""
    p, dc = tree["decoder"], cfg.decoder
    keys = keys_with_positions(tree, keys, text_positions)
    Q = stack(p["audio_encoder"], dc.audio_encoder, inputs)
    query = Q + _table_rows(p["embed_query_positions"]["w"], frame_positions)
    R, probs = attention(p["attention"], query, keys, values, mask)
    h = stack(p["audio_decoder"], dc.audio_decoder, torch.cat([R, Q], -1))
    frames, done = _head(p, h)
    return frames, probs, done, h


def init_state(cfg, B, device):
    """A decode's state before its first step: each causal layer's past
    inputs (zeros), the last attended key (0) and the frames decoded (0)."""
    dc = cfg.decoder

    def pasts(specs):
        return [torch.zeros(B, history(s), s.in_channels, device=device)
                for s in specs]

    return {"audio_encoder": pasts(dc.audio_encoder),
            "audio_decoder": pasts(dc.audio_decoder),
            "last_attended": torch.zeros(B, dtype=torch.int64, device=device),
            "pos": torch.zeros(B, dtype=torch.int64, device=device)}


def decoder_step(tree, cfg, keys, values, mask, state, x_t,
                 last_attended=None):
    """One step: x_t (B, F) the previous frame, keys already carrying
    their positions (`keys_with_positions`). The monotonic window sits at
    `last_attended` (default the state's). Returns (new state, frame
    (B, F), probabilities (B, Tk), done (B,), decoder state (B, D)); the new
    state's last attended key is the step's most probable one."""
    p, dc = tree["decoder"], cfg.decoder
    ae, Q = stack_step(p["audio_encoder"], dc.audio_encoder,
                       state["audio_encoder"], x_t)
    query = Q + _table_rows(p["embed_query_positions"]["w"],
                            state["pos"] + 1)
    la = state["last_attended"] if last_attended is None else last_attended
    R, probs = attention(p["attention"], query[:, None], keys, values, mask,
                         la if dc.force_monotonic_attention else None,
                         dc.window_backward, dc.window_ahead)
    probs = probs[:, 0]
    ad, h = stack_step(p["audio_decoder"], dc.audio_decoder,
                       state["audio_decoder"], torch.cat([R[:, 0], Q], -1))
    frame, done = _head(p, h)
    new = {"audio_encoder": ae, "audio_decoder": ad,
           "last_attended": torch.argmax(probs, dim=-1)
           if dc.force_monotonic_attention else la,
           "pos": state["pos"] + 1}
    return new, frame, probs, done[:, 0], h


def decode(tree, cfg, keys, values, text_positions, mask, steps):
    """Free-running decode of `steps` steps, each fed the frame it made
    before (zeros first). Returns (frames (B, steps, F), probabilities
    (B, steps, Tk), done (B, steps), states (B, steps, D), last attended
    (B,))."""
    B, dc = keys.shape[0], cfg.decoder
    keys = keys_with_positions(tree, keys, text_positions)
    state = init_state(cfg, B, keys.device)
    x_t = torch.zeros(B, dc.in_dim * dc.r, device=keys.device)
    outs = ([], [], [], [])
    for _ in range(steps):
        state, x_t, probs, done, h = decoder_step(tree, cfg, keys, values,
                                                  mask, state, x_t)
        for o, v in zip(outs, (x_t, probs, done, h)):
            o.append(v)
    return tuple(torch.stack(o, 1) for o in outs) + (state["last_attended"],)


def converter(tree, cfg, x):
    """(B, T, in_dim) decoder states (or mels) -> (B, 4T, Fd) normalised
    linear spectrogram."""
    return stack(tree["converter"]["layers"], cfg.converter.specs, x)
