# coding: utf-8
"""The parameter tree of a configuration, drawn from a seed on a device in
one call: the port's tree layout (dotted names as the JAX package's key
paths, (kw, in, out) conv weights, the weight-norm (g, v) split) and its
init distributions, with every normal draw a slice of one `torch.randn`
from a `torch.Generator` on the device."""

import math

import torch

from . import core
from . import deepvoice3 as dv3


class _Draw:
    """normal(shape, std) for the initializers. Pass one (`meta`) records
    the shapes; pass two hands out slices of one draw, scaled."""

    def __init__(self, device, flat=None):
        self.device = torch.device(device)
        self.flat = flat
        self.numel = 0

    def __call__(self, shape, std):
        n = math.prod(shape)
        if self.flat is None:
            self.numel += n
            return torch.empty(shape, device=self.device)
        v = self.flat[self.numel:self.numel + n].view(shape) * std
        self.numel += n
        return v


def _tree(cfg, draw):
    tree = {"encoder": dv3.encoder_init(draw, cfg.encoder),
            "decoder": dv3.decoder_init(draw, cfg.decoder),
            "converter": dv3.converter_init(draw, cfg.converter)}
    if cfg.n_speakers > 1:
        tree["embed_speakers"] = core.embedding_init(
            draw, cfg.n_speakers, cfg.speaker_embed_dim, None,
            cfg.speaker_embedding_weight_std)
    return tree


def seeded_tree(cfg, seed, device, done_bias=None):
    """Nested dict of f32 tensors on `device` from `seed`. done_bias: set
    the decoder's done projection to a constant (weight 0, bias
    done_bias), which a model without trained weights needs to decode a
    length the traffic sets."""
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


def flatten(tree, prefix=""):
    """Nested dict / list -> {dotted name: tensor}."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = "%s%s" % (prefix, k)
        if isinstance(v, torch.Tensor):
            out[name] = v
        else:
            out.update(flatten(v, name + "."))
    return out
