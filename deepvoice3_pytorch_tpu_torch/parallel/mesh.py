# coding: utf-8
"""Device mesh and sharding on torch.distributed, counterpart of
deepvoice3_pytorch_tpu/parallel/mesh.py.

A ("data", "model") `DeviceMesh` over the ranks of a process group, one
process per card (NCCL), or CPU processes (gloo):

  * "data": the batch axis. Every rank collates the same global batch and
    keeps its contiguous rows (`shard_batch`), so pad lengths and masks are
    the global batch's; each loss term divides by the global count
    (training/losses.py, `data_shard`) and the train step all-reduces the
    gradients (SUM) over "data" in one flat buffer, which gives the
    one-process gradient up to summation order.
  * "model": out-channel tensor parallelism. Conv and linear layers whose
    out channels divide by the axis keep one slice per rank
    (`param_shardings`, `shard_params`); inside `ops.core.tensor_parallel`
    such a layer computes its slice and all-gathers it on the channel axis
    (Megatron's column-parallel pair, ops/core.py).

  * sequence parallelism over "model" (`seq_sharding`, `shard_batch(...,
    sp=True)`): every model rank keeps its block of frames of the global
    batch, the encoder runs on the whole text on every rank, and inside
    `ops.core.sequence_parallel` every kw > 1 conv exchanges the halo of
    frames its window reaches across the block's edges (`HaloPlan`, an
    autograd Function in ops/core.py), so kernel B3 runs on halo-extended
    blocks. The tp slices stay the storage (moments, checkpoints, the
    clip's norm); the sp step gathers them whole before its forward and
    sums the gradients over "data" and "model" (training/trainer.py).

Every collective of the port goes through `all_reduce`, `all_gather` and
`broadcast` below, and none is caught: a failed collective ends the run.
"""

import collections
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..params import rebuilt, replace_leaves

DATA_AXIS = "data"
MODEL_AXIS = "model"


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def mesh_shape(world, n_data=None, n_model=1):
    """(n_data, n_model) of a mesh over `world` ranks, by the JAX
    `make_mesh`'s rule: n_data None (or <= 0) means world // n_model, and a
    mesh larger than the world raises the JAX message."""
    if n_data is None or n_data <= 0:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model > world:
        raise ValueError(
            "mesh %dx%d needs %d devices, have %d"
            % (max(n_data, 1), n_model, max(n_data, 1) * n_model, world))
    return n_data, n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, group=None,
              device="cuda"):
    """A (n_data, n_model) DeviceMesh named ("data", "model") over the ranks
    of `group` (the default group when None), on `device`'s type: the card
    unless the caller asks for the CPU.

    Without a process group the run is a world of one: the mesh can only be
    1 x 1, and a one-rank group (NCCL for the card, gloo for the CPU) is
    made for it. Unlike the JAX mesh, which may leave devices out, the mesh
    must hold every rank of the group: a rank outside it would have no
    rows."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = torch.device(device).type
    if dist.is_initialized():
        ranks = dist.get_process_group_ranks(
            group if group is not None else dist.group.WORLD)
    else:
        ranks = [0]
    n_data, n_model = mesh_shape(len(ranks), n_data, n_model)
    if n_data * n_model != len(ranks):
        raise ValueError(
            "mesh %dx%d leaves %d of the %d ranks without work; start as "
            "many processes as the mesh holds"
            % (n_data, n_model, len(ranks) - n_data * n_model, len(ranks)))
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    mesh = DeviceMesh(device_type,
                      torch.tensor(ranks).reshape(n_data, n_model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    mesh.dv3_group = group if group is not None else dist.group.WORLD
    return mesh


def axis_size(mesh, axis):
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh, axis):
    """This rank's coordinate on `axis`."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis):
    return mesh.get_group(axis)


def mesh_group(mesh):
    """The process group of every rank of the mesh (the group it was made
    over)."""
    return mesh.dv3_group


def is_main(mesh):
    """True on the rank that writes files: rank 0 of the run, or the only
    process when there is no mesh."""
    return mesh is None or dist.get_rank() == 0


def batch_sharding(mesh):
    """DTensor placements over (data, model) of a batch: the leading axis
    sharded over "data", replicated over "model" (`shard_batch` keeps this
    rank's part)."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh):
    """DTensor placements of a value every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def shard_rows(n_rows, n_data, data_rank):
    """The slice of the global batch's rows that data rank `data_rank`
    keeps: contiguous, in order, as a batch-sharded jax.Array's shards."""
    if n_rows % n_data:
        raise ValueError("a batch of %d rows does not divide over %d data "
                         "ranks" % (n_rows, n_data))
    per = n_rows // n_data
    return slice(data_rank * per, (data_rank + 1) * per)


def seq_sharding(mesh):
    """DTensor placements of a frame-sharded (B, T, ...) batch entry: rows
    over "data", frames over "model" (the JAX package's seq_sharding, P(data,
    model)). Given to `make_train_step(seq_sharding=)` it turns sequence
    parallelism on.

    The JAX step drops its Pallas conv for XLA's tap sum under sp
    (`resolve_conv_mode`), because GSPMD cannot partition the kernel's
    halo. The port writes the halo exchange itself (ops/core.py,
    `sequence_parallel`), so its sp step keeps conv_mode="kernel": B3 runs
    every kw > 1 conv on the halo-extended block. Both compute the same
    function."""
    from torch.distributed.tensor import Shard

    return (Shard(0), Shard(1))


# batch keys whose axis 1 counts decoder groups (r mel frames each); JAX's
# _SEQ_KEYS, "mel" and "y", count mel and linear frames
_GROUP_KEYS = ("frame_positions", "done")
# the r target frames that follow a rank's block of mel / y (the losses
# compare output frame t with target frame t + r), and the decoder groups
# of every model rank's block
NEXT_KEYS = {"mel": "mel_next", "y": "y_next"}
FRAME_GROUPS = "frame_groups"


def frame_groups(n_groups, n_model):
    """Decoder groups of each model rank's block: np.array_split's sizes
    (the first n_groups % n_model ranks take one more). A block is never
    empty."""
    if n_groups < n_model:
        raise ValueError("%d decoder frames do not split over %d model "
                         "ranks" % (n_groups, n_model))
    base, extra = divmod(n_groups, n_model)
    return tuple(base + (i < extra) for i in range(n_model))


def _frames_after(v, end, n):
    """v[:, end:end + n], zero frames past v's end."""
    part = v[:, end:end + n]
    if part.shape[1] == n:
        return part
    shape = tuple(part.shape[:1]) + (n - part.shape[1],) + tuple(
        part.shape[2:])
    if isinstance(v, torch.Tensor):
        return torch.cat([part, part.new_zeros(shape)], dim=1)
    return np.concatenate([part, np.zeros(shape, part.dtype)], axis=1)


def shard_batch(mesh, batch, *, sp: bool = False):
    """This rank's rows of every entry of `batch` (a dict of arrays or
    tensors with leading batch dims, the global collated batch; None entries
    stay None).

    sp=True also cuts the frame axis over "model" (`seq_sharding`): rank m
    keeps block m of `frame_groups(T_dec, n_model)` decoder groups of
    `frame_positions` and `done`, the same frames of `mel` (r mel frames a
    group) and of `y` (r * downsample_step linear frames a group), with r
    and downsample_step read from the shapes. It adds `mel_next` and
    `y_next`, the r target frames after the block (zeros past the end), and
    `frame_groups`, the blocks' sizes in decoder groups (a tuple of ints,
    which stays on the host)."""
    n_data, rank = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)
    out = {}
    for k, v in batch.items():
        out[k] = None if v is None else v[shard_rows(len(v), n_data, rank)]
    if not sp:
        return out
    n_groups = out["frame_positions"].shape[1]
    r = out["mel"].shape[1] // n_groups
    per_group = {"mel": r, "y": r * (out["y"].shape[1]
                                     // out["mel"].shape[1])}
    groups = frame_groups(n_groups, axis_size(mesh, MODEL_AXIS))
    m = axis_rank(mesh, MODEL_AXIS)
    start, end = sum(groups[:m]), sum(groups[:m + 1])
    for k in _GROUP_KEYS:
        out[k] = out[k][:, start:end]
    for k, f in per_group.items():
        out[NEXT_KEYS[k]] = _frames_after(out[k], end * f, r)
        out[k] = out[k][:, start * f:end * f]
    out[FRAME_GROUPS] = groups
    return out


class HaloPlan(NamedTuple):
    """Where the halo frames of one conv come from. Every model rank sends
    a strip of `left + right` frames: its last min(left, L) frames
    right-aligned in the first `left`, its first min(right, L) frames in
    the last `right`. `index[i]` is the position of halo frame i (the
    `left` frames before the block, then the `right` after it) in the
    ranks' strips laid end to end, or `zero` (the extra frame after them)
    for a frame past either end of the sequence."""
    index: tuple
    strip: int
    zero: int
    left: int
    right: int


@functools.lru_cache(maxsize=1024)
def halo_plan(lengths, rank, left, right):
    """The HaloPlan of model rank `rank` for blocks of `lengths` frames
    (every rank's, in order) and a conv that reads `left` frames before
    and `right` after each output frame. A halo longer than a block
    reaches as many ranks back (or on) as it needs."""
    starts = [sum(lengths[:j]) for j in range(len(lengths) + 1)]
    total, strip = starts[-1], left + right
    zero = strip * len(lengths)
    index = []
    for g in list(range(starts[rank] - left, starts[rank])) + list(
            range(starts[rank + 1], starts[rank + 1] + right)):
        if g < 0 or g >= total:
            index.append(zero)
            continue
        j = max(i for i in range(len(lengths)) if starts[i] <= g)
        p = g - starts[j]
        if g < starts[rank]:            # in j's tail
            index.append(j * strip + left - (lengths[j] - p))
        else:                           # in j's head
            index.append(j * strip + left + p)
    return HaloPlan(tuple(index), strip, zero, left, right)


def dropout_seed(base, mesh):
    """The dropout generator's seed of a step: `base` (the one-process seed
    of the step) on data rank 0 and without a mesh, and a seed of its own
    for each other data rank. Ranks of one data index share it, as their
    activations are replicated."""
    if mesh is None:
        return base
    return base + (axis_rank(mesh, DATA_AXIS) << 32)


# ---------------------------------------------------------------------------
# tensor-parallel layout
# ---------------------------------------------------------------------------


class TPLayout(NamedTuple):
    """Where a ParamTree's leaves lie over "model": `axes` maps the dotted
    name of each sharded leaf to its sharded axis; the rank holds block
    `rank` of `size` equal blocks of that axis."""
    axes: dict
    rank: int
    size: int

    def full_shape(self, name, shape):
        shape = list(shape)
        if name in self.axes:
            shape[self.axes[name]] *= self.size
        return tuple(shape)


def convT_layers(cfg):
    """Dotted prefixes of the transposed-conv layers (the converter's)."""
    return {"converter.layers.%d.conv" % i
            for i, s in enumerate(cfg.converter.specs) if s.kind == "convT"}


def tp_axes(shapes, n_model, convT=()):
    """Dotted name -> sharded axis for the leaves that tensor parallelism
    over `n_model` ranks slices, from the full shapes (name -> shape).

    The rule of the JAX `param_shardings(tp=True)`: a conv `v` (kw, in, out)
    or a linear `v` (in, out) shards its out axis when out % n_model == 0.
    Unlike the JAX rule, and on purpose, the same layer's `g` and `b` (both
    (out,)) shard with its `v`, and a transposed conv stays replicated:
    the port's weight norm (ops/core.py) normalises a conv over (kw, in)
    and a linear over in, each per out channel, so a rank's slice of (v, g,
    b) makes its slice of the weight alone; a transposed conv's norm is per
    *input* channel over (kw, out), so slicing its out axis would need a
    norm across ranks. Placement is not numerics: the results are the
    replicated model's either way."""
    axes = {}
    if n_model <= 1:
        return axes
    for name, shape in shapes.items():
        prefix, _, leaf = name.rpartition(".")
        if leaf != "v" or prefix in convT or len(shape) not in (2, 3):
            continue
        if shape[-1] % n_model:
            continue
        axes[name] = len(shape) - 1
        for other in ("g", "b"):
            if prefix + "." + other in shapes:
                axes[prefix + "." + other] = 0
    return axes


def _named_shapes(params):
    if isinstance(params, dict):
        return {k: tuple(v.shape) for k, v in params.items()}
    return {k: tuple(v.shape) for k, v in params.state_dict().items()}


def param_shardings(params, mesh, *, tp: bool = False, cfg=None):
    """Dotted name -> sharded axis (None: replicated) for every leaf of
    `params` (a ParamTree, or a name -> tensor dict, at full size). With
    tp=False everything is replicated; with tp=True the rule of `tp_axes`,
    which needs `cfg` to know the transposed convs."""
    shapes = _named_shapes(params)
    axes = {}
    if tp:
        if cfg is None:
            raise ValueError("param_shardings(tp=True) needs the model "
                             "config (its transposed convs stay "
                             "replicated)")
        axes = tp_axes(shapes, axis_size(mesh, MODEL_AXIS), convT_layers(cfg))
    return {k: axes.get(k) for k in shapes}


def _block(t, axis, rank, size):
    n = t.shape[axis] // size
    return t.narrow(axis, rank * n, n)


def shard_params(params, mesh, *, tp: bool = False, cfg=None):
    """Place a full ParamTree on the mesh, in place: every leaf is
    broadcast from the mesh's first rank (one flat buffer) and, with tp,
    each sharded leaf is replaced by this rank's block of its out channels.
    The tree records the layout as `params.tp_layout` (a TPLayout). Returns
    `params`."""
    specs = param_shardings(params, mesh, tp=tp, cfg=cfg)
    leaves = [p.data for p in params.parameters()]
    if mesh.mesh.numel() > 1:
        flat = _flatten_dense_tensors(leaves)
        broadcast_from_first(mesh, flat)
        torch._foreach_copy_(leaves, _unflatten_dense_tensors(flat, leaves))
    axes = {k: a for k, a in specs.items() if a is not None}
    layout = TPLayout(axes, axis_rank(mesh, MODEL_AXIS),
                      axis_size(mesh, MODEL_AXIS))
    if axes:
        named = dict(params.named_parameters())
        replace_leaves(params, {
            k: _block(named[k].data, a, layout.rank, layout.size).clone()
            for k, a in axes.items()})
    params.tp_layout = layout
    return params


def shard_moments(opt_state, layout):
    """The optimizer's moments sliced as `layout` slices their leaves (an
    AdamState over the full tree -> the same over this rank's blocks)."""
    def cut(plane):
        if plane is None:
            return None
        return {k: (_block(v, layout.axes[k], layout.rank, layout.size)
                    .clone() if k in layout.axes else v)
                for k, v in plane.items()}

    return opt_state._replace(mu=cut(opt_state.mu), nu=cut(opt_state.nu),
                              nu_max=cut(opt_state.nu_max))


def layout_of(params):
    return getattr(params, "tp_layout", None)


def gather_leaf(mesh, t, axis):
    """The full leaf from this rank's block (all-gather over "model")."""
    return all_gather(t.detach().contiguous(), axis_group(mesh, MODEL_AXIS),
                      dim=axis)


def gather_state(mesh, params, opt_state=None):
    """(full ParamTree, full AdamState or None) of a tp-sharded state: the
    sharded leaves and their moments all-gathered over "model", every rank
    taking part. A replicated tree (no tp layout) comes back as it is."""
    layout = layout_of(params)
    if layout is None or not layout.axes:
        return params, opt_state
    named = dict(params.named_parameters())
    full = {k: gather_leaf(mesh, named[k], a) for k, a in
            layout.axes.items()}
    out = rebuilt(params, lambda k, t: full.get(k, t.detach()))
    if opt_state is None:
        return out, None

    def grow(plane):
        if plane is None:
            return None
        return {k: (gather_leaf(mesh, v, layout.axes[k])
                    if k in layout.axes else v) for k, v in plane.items()}

    return out, opt_state._replace(mu=grow(opt_state.mu),
                                   nu=grow(opt_state.nu),
                                   nu_max=grow(opt_state.nu_max))


# ---------------------------------------------------------------------------
# the train step's reductions
# ---------------------------------------------------------------------------


def reduce_over_data(mesh, tensors, whole_mesh=False):
    """Sum every tensor of the list over "data" (in place), through one
    flat buffer a dtype: one collective for the whole list. whole_mesh:
    over every rank of the mesh ("data" and "model"), as the sp step's
    gradients and losses hold only this rank's frames."""
    group = mesh_group(mesh) if whole_mesh else axis_group(mesh, DATA_AXIS)
    by_dtype = collections.defaultdict(list)
    for t in tensors:
        by_dtype[t.dtype].append(t)
    for ts in by_dtype.values():
        flat = _flatten_dense_tensors(ts)
        all_reduce(flat, group)
        torch._foreach_copy_(ts, _unflatten_dense_tensors(flat, ts))
    return tensors


def gather_sliced(mesh, named, layout):
    """{dotted name: the whole leaf} of the tp-sliced leaves of `named`
    (name -> this rank's block), in one flat all-gather over "model": the
    sp step runs its forward on whole weights (ZeRO-3 style)."""
    names = sorted(layout.axes)
    local = [named[k].detach() for k in names]
    flat = _flatten_dense_tensors(local)
    parts = all_gather(flat, axis_group(mesh, MODEL_AXIS)).view(
        layout.size, -1)
    pieces = [_unflatten_dense_tensors(parts[m], local)
              for m in range(layout.size)]
    return {k: torch.cat([p[i] for p in pieces], dim=layout.axes[k])
            for i, k in enumerate(names)}


def own_block(layout, name, t):
    """This rank's block of a whole leaf (or its gradient) that `layout`
    slices; other leaves come back as they are."""
    if name not in layout.axes:
        return t
    return _block(t, layout.axes[name], layout.rank, layout.size)


def tp_global_norm(mesh, sharded, tensors):
    """The global norm of a gradient list whose leaves marked in `sharded`
    are this rank's blocks over "model": the sharded leaves' squared norms
    are summed over "model" (one all-reduce), the replicated leaves are
    counted once. Same form as trainer.global_norm."""
    norms = torch._foreach_norm(list(tensors))
    idx = [i for i, s in enumerate(sharded) if s]
    if idx:
        sq = torch.stack([norms[i] for i in idx]) ** 2
        all_reduce(sq, axis_group(mesh, MODEL_AXIS))
        full = torch.sqrt(sq)
        norms = list(norms)
        for j, i in enumerate(idx):
            norms[i] = full[j]
    return torch.linalg.vector_norm(torch.stack(norms))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

# calls and bytes by collective, and the calls staged through host memory
COUNTS = collections.Counter()


def reset_counts():
    COUNTS.clear()


def broadcast_from_first(mesh, t):
    """t overwritten in place with the value of the mesh's first rank (data
    0, model 0): along "model", then along "data". Returns t."""
    for axis in (MODEL_AXIS, DATA_AXIS):
        if axis_size(mesh, axis) > 1:
            broadcast(t, axis_group(mesh, axis))
    return t


def _staged(t, group):
    """A CUDA tensor in a gloo group goes through pinned host memory: gloo's
    CUDA collectives differ between builds, so the port does not rely on
    them. This is the transport, not a fallback: the kernels still run on
    the card."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _count(op, t, staged):
    COUNTS[op] += 1
    COUNTS[op + "_bytes"] += t.numel() * t.element_size()
    if staged:
        COUNTS["staged"] += 1


def count_halo(t):
    """One halo exchange of `t` (a forward's edge strip, a backward's
    strips), besides the collective that carries it."""
    COUNTS["halo"] += 1
    COUNTS["halo_bytes"] += t.numel() * t.element_size()


def _host(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """t (contiguous) reduced over `group` in place; returns t."""
    staged = _staged(t, group)
    _count("all_reduce", t, staged)
    if staged:
        h = _host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t, group, dim=0):
    """The group's tensors (each of t's shape) concatenated on `dim` in
    rank order."""
    t = t.contiguous()
    staged = _staged(t, group)
    _count("all_gather", t, staged)
    src = _host(t) if staged else t
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def broadcast(t, group, src=0):
    """t (contiguous) overwritten in place with the value of the group's
    rank `src`; returns t."""
    staged = _staged(t, group)
    _count("broadcast", t, staged)
    root = dist.get_global_rank(group, src)
    if staged:
        h = _host(t)
        dist.broadcast(h, src=root, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src=root, group=group)
    return t
