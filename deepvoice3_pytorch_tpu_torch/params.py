# coding: utf-8
"""Parameters as an `nn.Module` tree that mirrors the JAX pytree.

`ParamTree` turns a nested dict/list of tensors into modules: a dict becomes
a module whose children are its keys, a list an `nn.ModuleList`, a tensor a
frozen `nn.Parameter`. So `state_dict()` keys are the JAX key paths joined by
dots (`encoder.layers.3.conv.v`), shapes and layouts stay the JAX ones
((kw, in, out) conv weights, the weight-norm (g, v) split), and the apply
functions index a node exactly as the JAX code indexes its dict
(`p["conv"]["v"]`).
"""

from collections import OrderedDict

import numpy as np
import torch
from torch import nn


class ParamTree(nn.Module):
    """A dict node of the parameter tree."""

    def __init__(self, tree=None):
        super().__init__()
        for key, value in (tree or {}).items():
            setattr(self, key, _node(value))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        return key in self._parameters or key in self._modules

    @classmethod
    def from_state_dict(cls, state_dict):
        """Build the tree from dotted keys (see `nest`)."""
        return cls(nest(state_dict))


def nest(flat):
    """Dotted key -> tensor mapping to the nested dict/list tree, with the
    tensors themselves as leaves (so a tree of cast or differentiable
    tensors indexes like the parameters). A run of digit keys becomes a
    list; indices with no leaves (the JAX package's empty `{}` entries, e.g.
    decoder layers without attention) become empty dicts."""
    nested = {}
    for key, value in flat.items():
        parts = key.split(".")
        d = nested
        for part in parts[:-1]:
            d = d.setdefault(part, {})
        d[parts[-1]] = value
    return _listify(nested)


def _listify(d):
    if not isinstance(d, dict):
        return d
    d = {k: _listify(v) for k, v in d.items()}
    if d and all(k.isdigit() for k in d):
        return [d.get(str(i), {}) for i in range(max(map(int, d)) + 1)]
    return d


def _node(value):
    if isinstance(value, dict):
        return ParamTree(value)
    if isinstance(value, (list, tuple)):
        return nn.ModuleList([_node(v) for v in value])
    return nn.Parameter(torch.as_tensor(value), requires_grad=False)


def flatten_tree(tree, prefix=""):
    """Nested dict/list -> OrderedDict of dotted key -> leaf."""
    out = OrderedDict()
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = "%s%s" % (prefix, k)
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_tree(v, key + "."))
        else:
            out[key] = v
    return out


def params_from_jax(numpy_tree, cfg=None):
    """JAX parameter pytree (numpy leaves) -> torch state_dict.

    One `torch.from_numpy` per leaf, no layout change. With `cfg`, the keys
    and shapes must equal those of `model_init(cfg)` exactly."""
    sd = OrderedDict((k, torch.from_numpy(np.array(v, np.float32)))
                     for k, v in flatten_tree(numpy_tree).items())
    if cfg is not None:
        want = {k: tuple(v.shape) for k, v in param_shapes(cfg).items()}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if want.keys() != got.keys():
            raise KeyError("parameter keys differ: missing %s, unexpected %s"
                           % (sorted(want.keys() - got.keys()),
                              sorted(got.keys() - want.keys())))
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        if bad:
            raise ValueError("parameter shapes differ (got, want): %r" % bad)
    return sd


def param_shapes(cfg):
    """Dotted key -> init tensor (its shape is what callers read)."""
    return flatten_tree(_init_tree(cfg, torch.Generator()))


def _init_tree(cfg, generator):
    from .models import deepvoice3 as dv3

    if cfg.builder != "deepvoice3" or cfg.n_speakers > 1:
        raise NotImplementedError(
            "only the single-speaker deepvoice3 builder is ported")
    return {
        "encoder": dv3.encoder_init(generator, cfg.encoder),
        "decoder": dv3.decoder_init(generator, cfg.decoder),
        "converter": dv3.converter_init(generator, cfg.converter),
    }


def model_init(cfg, generator, device="cuda"):
    """Random parameters with the shapes and init distributions of the JAX
    package's `builder.model_init`, drawn from `generator` (values differ
    from JAX's for the same seed). Returns a `ParamTree` on `device`: the
    card unless the caller asks for the CPU."""
    tree = _init_tree(cfg, generator)
    return ParamTree(tree).to(device)
