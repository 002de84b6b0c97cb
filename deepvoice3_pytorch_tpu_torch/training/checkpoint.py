# coding: utf-8
"""Checkpoints, counterpart of deepvoice3_pytorch_tpu/training/checkpoint.py:
whole-model or seq2seq / postnet halves, exact resume, shape-tolerant
partial restore for speaker adaptation, embedding-only load, and an async
writer.

The file is the JAX package's: one msgpack blob (flax's wire format,
`utils/msgpack.py`) holding

    {global_epoch, global_step, opt_fingerprint, opt_state, params}

with every map's keys sorted, as flax writes them, so that a file either
package writes loads in the other, and both write the same bytes for the
same state.

  * `params` is the JAX parameter tree: dicts, lists (the `{}` entries of
    decoder layers without attention included) and float32 arrays, taken
    bit for bit from the `ParamTree`. The tree's structure is read from the
    ParamTree's modules, so it must be one that `model_init` built (or a
    `load_checkpoint` into one): a tree rebuilt from a flat state dict
    (`ParamTree.from_state_dict`) has lost a list's trailing empty entries.
  * `opt_state` is optax's leaf list of `chain([add_decayed_weights],
    [clip_by_global_norm], adam(schedule))`: Adam's count (int32, 0-d),
    its `mu` and then its `nu` in `jax.tree` order (dict keys sorted as
    strings, list entries in numeric order: `layers.10` after `layers.9`),
    then the schedule's count. Both counts are the port's
    `AdamState.count`.
  * `opt_fingerprint` is JAX's `opt_state_fingerprint` of that chain, the
    hash of a description built from optax's class names and the leaf
    shapes; either package refuses a file whose fingerprint differs from
    its optimizer's.

A file is read as msgpack, or as the pickle that the JAX package writes
when flax is absent. Loads copy into the template's tensors in place, on
their device.
"""

import glob
import hashlib
import os
import pickle
import queue
import threading
from os.path import join

import numpy as np
import torch
from torch import nn

from ..utils import msgpack

_ADAM = "ScaleByAdamState"
_SCHEDULE = "ScaleByScheduleState"
_EMPTY = "EmptyState"


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def param_tree(params):
    """ParamTree -> the JAX nested tree (dicts and lists) with the parameter
    tensors as leaves, empty entries kept."""
    if isinstance(params, nn.ModuleList):
        return [param_tree(m) for m in params]
    out = dict(params._parameters)
    for k, m in params._modules.items():
        out[k] = param_tree(m)
    return out


def jax_order(tree, prefix=""):
    """[(dotted name, leaf)] in `jax.tree` flatten order."""
    out = []
    items = ([(k, tree[k]) for k in sorted(tree)] if isinstance(tree, dict)
             else list(enumerate(tree)))
    for k, v in items:
        if isinstance(v, (dict, list)):
            out += jax_order(v, "%s%s." % (prefix, k))
        else:
            out.append(("%s%s" % (prefix, k), v))
    return out


def _map_tree(fn, tree):
    """The tree with each leaf replaced by fn(leaf) and every dict's keys
    sorted (the order flax writes)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _desc(tree):
    """JAX's `_structure_desc` of a parameter-shaped tree."""
    if isinstance(tree, dict):
        return "{" + ",".join("%s:%s" % (k, _desc(tree[k]))
                              for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ",".join(_desc(v) for v in tree) + "]"
    return "%s%s" % (str(tree.dtype).split(".")[-1], tuple(tree.shape))


def opt_state_fingerprint(opt_state, params):
    """JAX's opt_state_fingerprint for the optax chain that `opt_state` (an
    AdamState of `trainer.Optimizer`) stands for, over the tree of
    `params`."""
    tree = _desc(param_tree(params))
    adam = "[%s(count:int32(),mu:%s,nu:%s),%s(count:int32())]" % (
        _ADAM, tree, tree, _SCHEDULE)
    desc = "[" + ",".join(["%s()" % _EMPTY] * len(opt_state.transforms)
                          + [adam]) + "]"
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def flatten_opt_state(opt_state, params):
    """optax's leaf list of the chain: [count, mu..., nu..., count], the
    moments as tensors in JAX's order of `params`' names."""
    names = [k for k, _ in jax_order(param_tree(params))]
    count = torch.tensor(opt_state.count, dtype=torch.int32)
    return ([count] + [opt_state.mu[k] for k in names]
            + [opt_state.nu[k] for k in names] + [count])


def unflatten_opt_state(template, leaves, params):
    """Copy optax's leaf list into the moments of `template` (an AdamState)
    in place; returns the AdamState with the saved count."""
    names = [k for k, _ in jax_order(param_tree(params))]
    if len(leaves) != 2 * len(names) + 2:
        raise ValueError(
            "optimizer state mismatch: checkpoint has %d leaves, current "
            "optimizer expects %d -- resume with reset_optimizer=True "
            "(--reset-optimizer) or rebuild the matching optimizer"
            % (len(leaves), 2 * len(names) + 2))
    counts = [int(np.asarray(leaves[0])), int(np.asarray(leaves[-1]))]
    if counts[0] != counts[1]:
        raise ValueError("Adam's count %d and the schedule's count %d "
                         "differ; the port keeps one" % tuple(counts))
    targets = [template.mu[k] for k in names] + [template.nu[k]
                                                 for k in names]
    for i, (t, leaf) in enumerate(zip(targets, leaves[1:-1])):
        _copy_into(t, leaf, "optimizer state leaf %d" % (i + 1))
    return template._replace(count=counts[0])


def _copy_into(target, array, what):
    array = np.asarray(array)
    if tuple(target.shape) != array.shape:
        raise ValueError("%s has shape %s, expected %s -- the checkpoint's "
                         "layout does not match" % (
                             what, array.shape, tuple(target.shape)))
    with torch.no_grad():
        target.copy_(torch.from_numpy(np.array(array)))


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def _save_blob(blob, path):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(blob))
    os.replace(tmp, path)


def _load_blob(path):
    with open(path, "rb") as f:
        data = f.read()
    try:
        return msgpack.unpackb(data)
    except ValueError as e:
        try:
            return pickle.loads(data)
        except Exception:
            raise ValueError("%s is neither a msgpack checkpoint (%s) nor a "
                             "pickled one" % (path, e)) from e


def checkpoint_path(checkpoint_dir, step, suffix=""):
    return join(checkpoint_dir,
                "checkpoint_step{:09d}{}.ckpt".format(step, suffix))


def _host(t):
    return t.detach().cpu().numpy()


def _blob(params_np, opt_np, fingerprint, step, epoch):
    """The file's dict (numpy leaves), keys sorted."""
    return {
        "global_epoch": int(epoch),
        "global_step": int(step),
        "opt_fingerprint": fingerprint,
        "opt_state": opt_np,
        "params": params_np,
    }


def _host_blob(tree, opt_leaves, fingerprint, step, epoch):
    return _blob(_map_tree(_host, tree),
                 None if opt_leaves is None else [_host(t)
                                                  for t in opt_leaves],
                 fingerprint, step, epoch)


def _payload(params, train_seq2seq, train_postnet):
    tree = param_tree(params)
    if train_seq2seq and train_postnet:
        return "", tree
    if train_seq2seq:
        return "_seq2seq", {k: v for k, v in tree.items()
                            if k != "converter"}
    return "_postnet", {"converter": tree["converter"]}


class _AsyncWriter:
    """One background thread that writes snapshots to files in the order
    they were submitted. `submit` waits for the previous save to finish,
    then copies every tensor into buffers kept beside them (one batched
    `torch._foreach_copy_`, queued on the current stream after the step
    that made them) and returns; the thread copies the buffers to pinned
    host memory on a stream of its own, then encodes and writes. So at most
    one snapshot exists at a time, the buffers are reused from save to
    save, and the step loop pays for the device copy only."""

    def __init__(self):
        self._q = queue.Queue(maxsize=1)
        self._errors = []
        self._thread = None
        self._lock = threading.Lock()
        self._last_done = None
        self._dev = self._host = None

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="ckpt-writer", daemon=True)
                self._thread.start()

    def _buffers(self, tensors):
        key = [(t.shape, t.dtype, t.device) for t in tensors]
        if self._dev is None or [(t.shape, t.dtype, t.device)
                                 for t in self._dev] != key:
            self._dev = [torch.empty_like(t, memory_format=torch
                                          .contiguous_format)
                         for t in tensors]
            pin = any(t.is_cuda for t in tensors)
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=pin) if t.is_cuda else None
                          for t in tensors]
        return self._dev, self._host

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            make_blob, dev, host, event, path, done = item
            try:
                if event is not None:
                    stream = torch.cuda.Stream(device=event[1])
                    with torch.cuda.stream(stream):
                        stream.wait_event(event[0])
                        for h, d in zip(host, dev):
                            if h is not None:
                                h.copy_(d, non_blocking=True)
                    stream.synchronize()
                arrays = [(h if h is not None else d).numpy()
                          for h, d in zip(host, dev)]
                _save_blob(make_blob(arrays), path)
            except Exception as e:   # surfaced at the next wait()/submit
                self._errors.append(e)
            finally:
                done.set()
                self._q.task_done()

    def submit(self, tensors, make_blob, path):
        """Snapshot `tensors` and write make_blob(numpy arrays of the
        snapshot, in order) to `path` in the background."""
        self.raise_pending_errors()
        self._ensure_thread()
        if self._last_done is not None:
            self._last_done.wait()
            self.raise_pending_errors()
        dev, host = self._buffers(tensors)
        with torch.no_grad():
            torch._foreach_copy_(dev, list(tensors))
        event = None
        cuda = [t for t in tensors if t.is_cuda]
        if cuda:
            event = (torch.cuda.Event(), cuda[0].device)
            event[0].record(torch.cuda.current_stream(cuda[0].device))
        done = threading.Event()
        self._q.put((make_blob, dev, host, event, path, done))
        self._last_done = done
        return done

    def wait(self):
        """Block until every submitted save has been written; re-raise the
        first background failure."""
        if self._thread is not None and self._thread.is_alive():
            self._q.join()
        self.raise_pending_errors()

    def raise_pending_errors(self):
        if self._errors:
            e, self._errors = self._errors[0], []
            raise RuntimeError("async checkpoint save failed") from e


_writer = _AsyncWriter()


def wait_pending_saves():
    """Flush the async checkpoint writer (call before process exit and
    before any synchronous save that must supersede queued ones)."""
    _writer.wait()


def save_checkpoint(checkpoint_dir, params, opt_state, step, epoch, *,
                    train_seq2seq=True, train_postnet=True,
                    save_optimizer_state=True, async_save=False):
    """Whole / _seq2seq / _postnet suffixed saves. opt_state: the
    trainer's AdamState or None. async_save=True returns after the device
    snapshot; the file is written by the background writer (call
    wait_pending_saves() before exit) and holds the same bytes as a
    synchronous save of the same state."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    suffix, tree = _payload(params, train_seq2seq, train_postnet)
    keep_opt = save_optimizer_state and opt_state is not None
    opt_leaves = flatten_opt_state(opt_state, params) if keep_opt else None
    fingerprint = opt_state_fingerprint(opt_state, params) if keep_opt \
        else None
    path = checkpoint_path(checkpoint_dir, int(step), suffix)
    if not async_save:
        _save_blob(_host_blob(tree, opt_leaves, fingerprint, step, epoch),
                   path)
        return path
    leaves = [t for _, t in jax_order(tree)]
    tensors = leaves + (opt_leaves[1:-1] if keep_opt else [])
    count = _host(opt_leaves[0]) if keep_opt else None

    def make_blob(arrays):
        at = {id(t): a for t, a in zip(leaves, arrays)}
        opt = None if count is None \
            else [count] + arrays[len(leaves):] + [count]
        return _blob(_map_tree(lambda t: at[id(t)], tree), opt,
                     fingerprint, step, epoch)

    _writer.submit(tensors, make_blob, path)
    return path


def save_checkpoint_file(path, params, opt_state, step, epoch):
    """Save a whole-model checkpoint to an explicit path (used by
    cli.convert_checkpoint and tooling)."""
    tree = param_tree(params)
    opt_leaves = None if opt_state is None \
        else flatten_opt_state(opt_state, params)
    fingerprint = None if opt_state is None \
        else opt_state_fingerprint(opt_state, params)
    _save_blob(_host_blob(tree, opt_leaves, fingerprint, step, epoch),
               path)
    return path


def _saved_list(saved, n):
    """msgpack may carry a list as a dict of "0", "1", ... keys."""
    if isinstance(saved, dict):
        return [saved.get(str(i)) for i in range(n)]
    return saved


def _merge_exact(template, saved, prefix=""):
    """Copy every leaf that `saved` holds into the template's tensor (same
    shape required); leaves it lacks keep their values (partial
    payloads)."""
    if saved is None:
        return
    if isinstance(template, dict):
        for k, v in template.items():
            if k in saved:
                _merge_exact(v, saved[k], prefix + k + ".")
        return
    if isinstance(template, list):
        saved = _saved_list(saved, len(template))
        for i, (t, s) in enumerate(zip(template, saved)):
            _merge_exact(t, s, "%s%d." % (prefix, i))
        return
    _copy_into(template, saved, "parameter %s" % prefix[:-1])


def load_checkpoint(path, params_template, opt_state_template=None, *,
                    reset_optimizer=False):
    """Exact resume. params_template: a ParamTree, loaded in place on its
    device; opt_state_template: an AdamState from the optimizer to resume
    (its moments are loaded in place). Returns (params, opt_state_or_None,
    step, epoch)."""
    blob = _load_blob(path)
    _merge_exact(param_tree(params_template), blob["params"])
    opt_state = None
    if not reset_optimizer and blob.get("opt_state") is not None \
            and opt_state_template is not None:
        saved_fp = blob.get("opt_fingerprint")
        if saved_fp is not None and saved_fp != opt_state_fingerprint(
                opt_state_template, params_template):
            raise ValueError(
                "optimizer state structure mismatch: the checkpoint was "
                "saved with a different optimizer chain (e.g. weight_decay "
                "or the clip toggled). Resume with reset_optimizer=True "
                "(--reset-optimizer) to discard it.")
        opt_state = unflatten_opt_state(opt_state_template,
                                        blob["opt_state"], params_template)
    return (params_template, opt_state, int(blob["global_step"]),
            int(blob["global_epoch"]))


def restore_parts(path, params_template):
    """Shape-tolerant partial restore: leaves whose path exists and whose
    shape matches are copied from the checkpoint, everything else keeps the
    template's value (speaker adaptation). In place; returns the
    template."""
    blob = _load_blob(path)

    def merge(t, s):
        if isinstance(t, dict):
            for k, v in t.items():
                merge(v, s.get(k) if isinstance(s, dict) else None)
            return
        if isinstance(t, list):
            s = _saved_list(s, len(t))
            if isinstance(s, list) and len(s) == len(t):
                for a, b in zip(t, s):
                    merge(a, b)
            return
        if s is None:
            return
        arr = np.asarray(s)
        if tuple(t.shape) == arr.shape:   # skip other sizes, as the
            _copy_into(t, arr, "")        # reference warns and skips
    merge(param_tree(params_template), blob["params"])
    return params_template


def load_embedding(path, params):
    """Reuse a trained text embedding: copies encoder.embed_tokens from the
    checkpoint into `params` in place; returns `params`."""
    blob = _load_blob(path)
    emb = blob["params"]["encoder"]["embed_tokens"]
    _merge_exact(param_tree(params)["encoder"]["embed_tokens"], emb,
                 "encoder.embed_tokens.")
    return params


def latest_checkpoint(checkpoint_dir, suffix=""):
    paths = sorted(glob.glob(join(checkpoint_dir,
                                  "checkpoint_step*%s.ckpt" % suffix)))
    paths = [p for p in paths
             if suffix or ("_seq2seq" not in p and "_postnet" not in p)]
    return paths[-1] if paths else None
