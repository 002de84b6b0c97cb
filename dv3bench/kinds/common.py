# coding: utf-8
"""Set-up every traffic kind shares: the port's hparams and model configuration
from a configuration file, the reference's, and the seeded weights."""

import torch

from ..reference import builder as ref_builder
from ..reference import params as ref_params
from ..reference import text as ref_text


def port_hparams(hp):
    """The port's hparams with the configuration file's values."""
    from deepvoice3_pytorch_tpu_torch import hparams

    php = hparams.default_hparams()
    known = php.values()
    php.override_from_dict({k: v for k, v in hp.items() if k in known})
    return php


def configs(hp):
    """(port hparams, port model config, reference model config)."""
    from deepvoice3_pytorch_tpu_torch import model_builder
    from deepvoice3_pytorch_tpu_torch.frontend import en

    php = port_hparams(hp)
    return (php, model_builder.build_config(php, en.n_vocab),
            ref_builder.config_from_hparams(hp, ref_text.N_VOCAB))


def weight_seed(seed):
    return int(seed) % (2 ** 63)


def weights(cfg_ref, seed, device, done_bias=None):
    """The seeded weights as a nested dict of tensors on `device` (one
    draw), made anew on every call."""
    return ref_params.seeded_tree(cfg_ref, weight_seed(seed), device,
                                  done_bias=done_bias)


def port_params(tree):
    from deepvoice3_pytorch_tpu_torch.params import ParamTree

    return ParamTree(tree)


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device):
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def free(device):
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
