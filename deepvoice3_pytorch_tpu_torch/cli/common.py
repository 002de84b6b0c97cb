# coding: utf-8
"""What the command lines share: hparams from a preset and overrides, the
device, the process group of a torchrun launch, and the kernels' launch
counts."""

import json
import os

import torch
import torch.distributed as dist

from ..hparams import default_hparams


def load_hparams(preset=None, overrides="", require_name=True):
    """Default hparams, then the preset's JSON, then the `a=1,b=2`
    overrides (the root scripts' order)."""
    hp = default_hparams()
    if preset is not None:
        with open(preset) as f:
            hp.parse_json(f.read())
    hp.parse(overrides)
    if require_name and hp.name != "deepvoice3":
        raise SystemExit("hparams.name must be 'deepvoice3', got %r"
                         % hp.name)
    return hp


def add_device_argument(parser):
    parser.add_argument("--device", default="cuda",
                        help="device to run on [default: cuda]; pass cpu "
                             "to run every kernel's plain PyTorch version "
                             "on the CPU")


def pick_device(name):
    """torch.device(name); a CUDA device must exist (no silent fallback to
    the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "false); pass --device cpu to run on the CPU")
    return dev


def init_distributed(device_name):
    """Join the process group that torchrun (python -m
    torch.distributed.run) describes in the environment: RANK, WORLD_SIZE,
    LOCAL_RANK and MASTER_ADDR / MASTER_PORT. On the card each process
    takes card LOCAL_RANK and the group is NCCL's; on the CPU gloo's.
    Returns this process's device, or None without that environment (one
    process, as before). A group that fails to form raises."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    device = pick_device(device_name)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return device


def make_run_mesh(device, n_model=1):
    """The run's mesh over every rank (a world of one without torchrun,
    where n_model > 1 raises the JAX message), printed by rank 0."""
    from ..parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(n_model=n_model, device=device)
    if mesh_lib.is_main(mesh):
        print("Mesh: data=%d, model=%d over %d process(es), %s" % (
            mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS),
            mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS),
            dist.get_world_size(), dist.get_backend()), flush=True)
    return mesh


def _kernels():
    from ..dsp import gl_cuda
    from ..ops import conv_cuda
    from ..ops import fused_decode

    return (("fused_decode", fused_decode.KERNEL),
            ("griffin_lim", gl_cuda.KERNEL), ("conv_taps", conv_cuda.KERNEL))


def reset_launches():
    for _, k in _kernels():
        k.reset_counts()


def kernel_launches():
    """Launches each hand-written kernel's wrapper made in this process:
    {kernel: {"launches", "by_entry", "by_route"}}."""
    return {name: {"launches": k.launches, "by_entry": dict(k.by_entry),
                   "by_route": dict(k.by_route)} for name, k in _kernels()}


def print_launches():
    print("kernel launches: %s" % json.dumps(kernel_launches()), flush=True)


def pyplot():
    """matplotlib's pyplot and colormaps, or None when it is absent."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    from matplotlib import cm
    from matplotlib import pyplot as plt
    return plt, cm


def plot_alignment(plt, alignment, path, info=None):
    fig, ax = plt.subplots()
    im = ax.imshow(alignment, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    xlabel = "Decoder timestep"
    if info is not None:
        xlabel += "\n\n" + info
    plt.xlabel(xlabel)
    plt.ylabel("Encoder timestep")
    plt.tight_layout()
    plt.savefig(path, format="png")
    plt.close()
