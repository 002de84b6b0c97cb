# coding: utf-8
"""Import r9y9/deepvoice3_pytorch checkpoints into the parameter tree, a copy
of deepvoice3_pytorch_tpu/utils/torch_import.py on the port's own ConvSpec.

The reference stores torch state_dicts with weight-norm split into
``weight_g``/``weight_v`` (modules.py:85,100,109). This module maps those keys
onto our layouts:

    Linear   (out, in)      -> v (in, out),      g (out,)
    Conv1d   (out, in, kw)  -> v (kw, in, out),  g (out,)
    ConvT1d  (in, out, kw)  -> v (kw, in, out),  g (in,)

Input is any mapping name -> numpy array (call ``.numpy()`` on torch tensors
first; no torch dependency here). Structure bookkeeping is driven by our own
static configs, since the reference interleaves parameter-free ReLU modules
in its ModuleLists.
"""

import numpy as np


def _np(x):
    return np.asarray(x)


def _linear(sd, prefix):
    return {"v": _np(sd[prefix + ".weight_v"]).T,
            "g": _np(sd[prefix + ".weight_g"]).reshape(-1),
            "b": _np(sd[prefix + ".bias"])}


def _conv1d(sd, prefix):
    return {"v": _np(sd[prefix + ".weight_v"]).transpose(2, 1, 0),
            "g": _np(sd[prefix + ".weight_g"]).reshape(-1),
            "b": _np(sd[prefix + ".bias"])}


def _convT1d(sd, prefix):
    return {"v": _np(sd[prefix + ".weight_v"]).transpose(2, 0, 1),
            "g": _np(sd[prefix + ".weight_g"]).reshape(-1),
            "b": _np(sd[prefix + ".bias"])}


def _embedding(sd, prefix):
    return {"w": _np(sd[prefix + ".weight"])}


def _import_stack(sd, prefix, specs, *, separate_relu=True):
    """Map a reference ModuleList/Sequential onto a stack of
    ops.conv_blocks.ConvSpec.

    Our conv1x1+activation specs fuse the reference's (Conv1d, ReLU) pairs,
    so the reference index advances by 2 for them when separate_relu.
    """
    params = []
    ref_idx = 0
    for spec in specs:
        name = "%s.%d" % (prefix, ref_idx)
        if spec.kind == "convT":
            params.append({"conv": _convT1d(sd, name)})
            ref_idx += 1
        elif spec.kind in ("conv1x1", "conv"):
            params.append({"conv": _conv1d(sd, name)})
            ref_idx += 1
            if spec.activation in ("relu", "sigmoid") and separate_relu:
                ref_idx += 1  # parameter-free nn.ReLU / nn.Sigmoid entry
        else:  # glu / highway — Conv1dGLU/HighwayConv1d wrap a .conv
            p = {"conv": _conv1d(sd, name + ".conv")}
            if spec.speaker_proj:
                p["speaker_proj"] = _linear(sd, name + ".speaker_proj")
            params.append(p)
            ref_idx += 1
    return params


def _import_attention(sd, prefix, spec):
    if spec is None:
        return {}
    p = {"query_proj": _linear(sd, prefix + ".query_projection"),
         "out_proj": _linear(sd, prefix + ".out_projection")}
    if spec.key_projection:
        p["key_proj"] = _linear(sd, prefix + ".key_projection")
    if spec.value_projection:
        p["value_proj"] = _linear(sd, prefix + ".value_projection")
    return p


def import_deepvoice3_state_dict(sd, cfg):
    """Full-model state_dict -> params pytree for builder deepvoice3 /
    deepvoice3_multispeaker."""
    enc, dec, conv = cfg.encoder, cfg.decoder, cfg.converter

    encoder = {
        "embed_tokens": _embedding(sd, "seq2seq.encoder.embed_tokens"),
        "layers": _import_stack(sd, "seq2seq.encoder.convolutions",
                                enc.specs),
    }
    if cfg.n_speakers > 1:
        encoder["speaker_fc1"] = _linear(sd, "seq2seq.encoder.speaker_fc1")
        encoder["speaker_fc2"] = _linear(sd, "seq2seq.encoder.speaker_fc2")

    decoder = {
        "embed_query_positions": _embedding(
            sd, "seq2seq.decoder.embed_query_positions"),
        "embed_keys_positions": _embedding(
            sd, "seq2seq.decoder.embed_keys_positions"),
        "prenet": _import_stack(sd, "seq2seq.decoder.preattention",
                                dec.prenet_specs),
        "convs": _import_stack(sd, "seq2seq.decoder.convolutions",
                               dec.conv_specs),
        "attention": [
            _import_attention(sd, "seq2seq.decoder.attention.%d" % i, spec)
            for i, spec in enumerate(dec.attention_specs)],
        "last_conv": _conv1d(sd, "seq2seq.decoder.last_conv"),
        "fc": _linear(sd, "seq2seq.decoder.fc"),
    }
    if cfg.n_speakers > 1:
        decoder["speaker_proj1"] = _linear(sd, "seq2seq.decoder.speaker_proj1")
        decoder["speaker_proj2"] = _linear(sd, "seq2seq.decoder.speaker_proj2")

    converter = {"layers": _import_stack(sd, "postnet.convolutions",
                                         conv.specs)}

    params = {"encoder": encoder, "decoder": decoder, "converter": converter}
    if cfg.n_speakers > 1:
        params["embed_speakers"] = _embedding(sd, "embed_speakers")
    return params


def import_nyanko_state_dict(sd, cfg):
    """Full-model state_dict -> params pytree for builder nyanko."""
    enc, dec, conv = cfg.encoder, cfg.decoder, cfg.converter

    encoder = {
        "embed_tokens": _embedding(sd, "seq2seq.encoder.embed_tokens"),
        "layers": _import_stack(sd, "seq2seq.encoder.convnet", enc.specs),
    }
    decoder = {
        "embed_query_positions": _embedding(
            sd, "seq2seq.decoder.embed_query_positions"),
        "embed_keys_positions": _embedding(
            sd, "seq2seq.decoder.embed_keys_positions"),
        "audio_encoder": _import_stack(
            sd, "seq2seq.decoder.audio_encoder_modules", dec.audio_encoder),
        "attention": _import_attention(sd, "seq2seq.decoder.attention",
                                       dec.attention_spec),
        "audio_decoder": _import_stack(
            sd, "seq2seq.decoder.audio_decoder_modules", dec.audio_decoder),
        "last_conv": _conv1d(sd, "seq2seq.decoder.last_conv"),
        "fc": _linear(sd, "seq2seq.decoder.fc"),
    }
    converter = {"layers": _import_stack(sd, "postnet.convnet", conv.specs)}
    return {"encoder": encoder, "decoder": decoder, "converter": converter}


def import_state_dict(sd, cfg):
    """Dispatch on builder name; sd maps name -> numpy array."""
    if cfg.builder == "nyanko":
        return import_nyanko_state_dict(sd, cfg)
    return import_deepvoice3_state_dict(sd, cfg)
