"""Sharded checkpoints of the data-parallel tier.

The port of ``deeplearning4j_tpu/utils/sharded_checkpoint.py``. The JAX
module writes orbax, which this package does not use; the format here is
its own, a directory:

    index.json      the data world size that wrote it (and the model
                    world of a tensor-parallel trainer), and for every
                    leaf (by its keystr path) the whole shape, the dtype,
                    the dim it was split on over the data axis and the dim
                    it was split on over the model axis (null: whole),
                    plus the scalars
    shard-<r>.pt    the pieces of the rank at data index d and model index
                    m, r = d * model_world + m: its piece of every split
                    leaf (the data shard of its model slice), and the
                    leaves whole over an axis from index 0 of that axis
    dl4j_bundle_extras.zip   optional: ``buckets.json``

Every rank writes its own pieces; nothing is gathered to one rank. A
restore re-splits the saved leaves for the destination's layout and world
size: each leaf is reassembled from the pieces that hold it (the data
shards of each model slice, then the model slices) and cut to the
destination's splits (its model slice, then that slice's data shard), so a
checkpoint written by a replicated trainer on 4 ranks resumes into a
ZeRO-1, FSDP or FSDP_STREAM trainer on 2 (and back), and a tensor-parallel
trainer's on data=2 x model=2 resumes on data=4 or at world 1.
The single-process zip (``utils/serialization.py``) stays the format of a
whole network; ``ParallelTrainer.adopt_net_state`` places one in any
layout.
"""

from __future__ import annotations

import json
import os
import pathlib
import zipfile

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.utils.trees import flatten_tree, tree_leaves, tree_like

FORMAT = "dl4j-torch-sharded/1"
_EXTRAS_NAME = "dl4j_bundle_extras.zip"


def _rank_world(group):
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _barrier(group):
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.barrier(group=group)


def _barrier_model(model_group):
    """A barrier over a tensor-parallel trainer's model group (none
    without one: never the default group)."""
    if model_group is not None:
        _barrier(model_group)


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _dims(leaves, splits):
    return (dict(zip(leaves, tree_leaves(splits))) if splits is not None
            else dict.fromkeys(leaves))


def save_sharded(path, tree, splits=None, *, scalars=None, group=None, model_splits=None,
                 model_group=None):
    """Write this rank's pieces of ``tree`` (a tree of tensors; ``splits``
    the same tree of split dims over ``group``, None for a whole leaf,
    default all whole; ``model_splits`` likewise over ``model_group``) into
    the directory ``path``. Every rank of both groups calls it. Returns the
    path."""
    path = pathlib.Path(path)
    rank, world = _rank_world(group)
    mrank, mworld = _rank_world(model_group) if model_group is not None else (0, 1)
    path.mkdir(parents=True, exist_ok=True)
    leaves = flatten_tree(tree)
    dims, mdims = _dims(leaves, splits), _dims(leaves, model_splits)
    pieces = {}
    index = {}
    for name, t in leaves.items():
        d, md = dims[name], mdims[name]
        shape = list(t.shape)
        if d is not None:
            shape[d] *= world
        if md is not None:
            shape[md] *= mworld
        index[name] = {"shape": shape, "dtype": _dtype_name(t), "split": d, "model_split": md}
        if (d is not None or rank == 0) and (md is not None or mrank == 0):
            pieces[name] = t.detach().cpu().contiguous()
    torch.save(pieces, path / f"shard-{rank * mworld + mrank}.pt")
    _barrier(group)
    _barrier_model(model_group)
    if rank == 0 and mrank == 0:
        (path / "index.json").write_text(json.dumps(
            {"format": FORMAT, "world": world, "model_world": mworld, "leaves": index,
             "scalars": scalars or {}}, indent=1))
    _barrier(group)
    _barrier_model(model_group)
    return str(path)


def read_index(path):
    return json.loads((pathlib.Path(path) / "index.json").read_text())


def _cut(t, d, rank, world):
    if d is None:
        return t
    c = t.shape[d] // world
    return t.narrow(d, rank * c, c)


def restore_sharded(path, like, splits=None, *, group=None, model_splits=None,
                    model_group=None):
    """The pieces of the checkpoint at ``path`` for this rank: a tree
    shaped as ``like`` (each leaf's device and dtype), each leaf cut to this
    rank's slice on its ``model_splits`` dim over ``model_group``, then to
    its shard on its ``splits`` dim over ``group`` (None: whole)."""
    path = pathlib.Path(path)
    index = read_index(path)
    sw, smw = index["world"], index.get("model_world", 1)
    saved = [torch.load(path / f"shard-{r}.pt", map_location="cpu", weights_only=True)
             for r in range(sw * smw)]
    rank, world = _rank_world(group)
    mrank, mworld = _rank_world(model_group) if model_group is not None else (0, 1)
    like_leaves = flatten_tree(like)
    dims, mdims = _dims(like_leaves, splits), _dims(like_leaves, model_splits)
    out = []
    for name, t in like_leaves.items():
        meta = index["leaves"].get(name)
        if meta is None:
            raise KeyError(f"checkpoint {path} has no leaf {name}")
        sd, smd = meta["split"], meta.get("model_split")

        def model_slice(m, name=name, sd=sd):
            if sd is None:
                return saved[m][name]
            return torch.cat([saved[d * smw + m][name] for d in range(sw)], dim=sd)
        whole = (torch.cat([model_slice(m) for m in range(smw)], dim=smd) if smd is not None
                 else model_slice(0))
        whole = _cut(_cut(whole, mdims[name], mrank, mworld), dims[name], rank, world)
        if tuple(whole.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {name}: {tuple(whole.shape)} does not fit "
                             f"{tuple(t.shape)}")
        out.append(whole.to(device=t.device, dtype=t.dtype))
    return tree_like(like, iter(out))


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

class _Split:
    def __init__(self, dim):
        self.dim = dim


def _trainer_trees(trainer):
    """(tree, splits, model splits) of everything a resume needs:
    parameters, updater state and layer state, as this trainer stores them
    (a tensor-parallel trainer: its model rank's slices, and their dims;
    else None)."""
    if trainer._mg is not None:
        trainer._tp_local()
    plan = trainer._plan
    if trainer.shard_params in ("fsdp", "fsdp_stream"):
        dims = iter(plan.dims)
        p_splits = tree_like(trainer.params, (next(dims) if tr else None
                                              for tr in trainer._trainable_mask))
    else:
        p_splits = tree_like(trainer.params, (None for _ in trainer._trainable_mask))
    if trainer._zero:
        marked = trainer._opt_sliced(trainer.opt_state, trainer.net.params,
                                     lambda j, t: _Split(plan.dims[j]))
        o_splits = tree_like(marked, (m.dim if isinstance(m, _Split) else None
                                      for m in tree_leaves(marked)))
    else:
        o_splits = tree_like(trainer.opt_state, (None for _ in tree_leaves(trainer.opt_state)))
    tree = {"params": trainer.params, "opt_state": trainer.opt_state, "state": trainer.state}
    whole_state = tree_like(trainer.state, (None for _ in tree_leaves(trainer.state)))
    splits = {"params": p_splits, "opt_state": o_splits, "state": whole_state}
    if trainer._mg is None:
        return tree, splits, None
    p_model = tree_like(trainer.params, iter(trainer._tp_dims))
    marked = trainer._opt_sliced(trainer.opt_state, trainer.net.params,
                                 lambda j, t: _Split(trainer._tp_dims[_all_index(trainer, j)]))
    o_model = tree_like(marked, (m.dim if isinstance(m, _Split) else None
                                 for m in tree_leaves(marked)))
    return tree, splits, {"params": p_model, "opt_state": o_model, "state": whole_state}


def _all_index(trainer, j):
    """The index among all parameter leaves of trainable leaf ``j``."""
    return [i for i, tr in enumerate(trainer._trainable_mask) if tr][j]


def _save_named(path, trainer):
    """The pipelines' form: every rank writes the tensors it holds under
    their global names (``trainer.checkpoint_leaves()``); a restore takes
    each name from whichever shard holds it."""
    path = pathlib.Path(path)
    rank, world = _rank_world(None)
    if rank == 0:
        path.mkdir(parents=True, exist_ok=True)
    _barrier(None)
    torch.save({k: t.detach().cpu().contiguous()
                for k, t in trainer.checkpoint_leaves().items()}, path / f"shard-{rank}.pt")
    if rank == 0:
        (path / "index.json").write_text(json.dumps(
            {"format": FORMAT, "kind": "named", "world": world,
             "scalars": {"iteration": int(trainer.iteration)}}, indent=1))
    _barrier(None)
    return str(path)


def _restore_named(path, trainer, index):
    named = {}
    for r in range(index["world"]):
        for k, t in torch.load(pathlib.Path(path) / f"shard-{r}.pt", map_location="cpu",
                               weights_only=True).items():
            named.setdefault(k, t)
    trainer.load_checkpoint_leaves(named)
    trainer.iteration = int(index["scalars"].get("iteration", 0))
    return trainer


def save_trainer(path, trainer, *, buckets=None, manifest=None):
    """Checkpoint a ``ParallelTrainer`` in its layout (every rank calls
    it): parameters, updater state, layer state, iteration and epoch, and
    in the extras zip ``buckets.json`` with ``buckets`` (a BucketRegistry
    or sizes) and ``warm_manifest.zip`` with ``manifest`` (a
    ``utils/compile_cache.WarmManifest``; by default the one attached to
    the trainer's net), the JAX package's instant-restart unit (JAX
    ``sharded_checkpoint.py:82-103``). A pipelined trainer (``PipelinedNetwork``, ``PipelinedGraph``,
    ``PipelineParallelLM``, ``ComposedParallelLM``) writes the tensors
    each rank holds by their global names. Returns the path."""
    if hasattr(trainer, "checkpoint_leaves"):
        return _save_named(path, trainer)
    tree, splits, model_splits = _trainer_trees(trainer)
    mgroup = trainer._mg.group if trainer._mg is not None else None
    path = save_sharded(path, tree, splits, group=trainer.group, model_splits=model_splits,
                        model_group=mgroup,
                        scalars={"iteration": int(trainer.iteration),
                                 "epoch": int(trainer.epoch), "layout": trainer.layout})
    rank, _ = _rank_world(trainer.group)
    if manifest is None:
        manifest = getattr(trainer.net, "_warm_manifest", None)
    has_manifest = manifest is not None and len(manifest) > 0
    if ((buckets is not None or has_manifest) and rank == 0
            and (mgroup is None or _rank_world(mgroup)[0] == 0)):
        from deeplearning4j_tpu_torch.utils.serialization import bucket_sizes
        with zipfile.ZipFile(os.path.join(path, _EXTRAS_NAME), "w", zipfile.ZIP_DEFLATED) as z:
            if buckets is not None:
                z.writestr("buckets.json", json.dumps(bucket_sizes(buckets)))
            if has_manifest:
                z.writestr("warm_manifest.zip", manifest.to_bytes())
    _barrier(trainer.group)
    _barrier_model(mgroup)
    return path


def restore_trainer(path, trainer):
    """Restore into ``trainer`` (initialised first if it is not) in ITS
    layout and world size, whatever wrote the checkpoint: the tensors are
    copied in place, the counters set, a bucket registry lands on
    ``trainer.buckets``, and an embedded warm manifest built for this net
    on this backend is attached to ``trainer.net`` (JAX
    ``sharded_checkpoint.py:170-185``; another one is dropped with a
    warning, ``compile_cache.attach_if_matches``), so the first K-step
    dispatch installs its libraries and seeds its plans from it. Returns
    the trainer."""
    if trainer.params is None:
        trainer.init()
    index = read_index(path)
    if index.get("kind") == "named":
        return _restore_named(path, trainer, index)
    tree, splits, model_splits = _trainer_trees(trainer)
    got = restore_sharded(path, tree, splits, group=trainer.group, model_splits=model_splits,
                          model_group=trainer._mg.group if trainer._mg is not None else None)
    with torch.no_grad():
        for dst, src in zip(tree_leaves(tree), tree_leaves(got)):
            dst.copy_(src)
    scalars = read_index(path)["scalars"]
    trainer.iteration = int(scalars.get("iteration", 0))
    trainer.epoch = int(scalars.get("epoch", 0))
    extras = pathlib.Path(path) / _EXTRAS_NAME
    if extras.exists():
        from deeplearning4j_tpu_torch.datasets.iterator import BucketRegistry
        from deeplearning4j_tpu_torch.utils import compile_cache as _cc
        with zipfile.ZipFile(extras) as z:
            names = z.namelist()
            if "buckets.json" in names:
                trainer.buckets = BucketRegistry(json.loads(z.read("buckets.json")))
            if "warm_manifest.zip" in names:
                manifest = _cc.WarmManifest.load_lenient(
                    z.read("warm_manifest.zip"),
                    context=f"checkpoint {path}: embedded warm manifest")
                if manifest is not None:
                    _cc.attach_if_matches(trainer.net, manifest, f"checkpoint {path}")
    # the HBM ledger of the restored layout (JAX sharded_checkpoint.py:154)
    from deeplearning4j_tpu_torch.telemetry import devices as _devices
    _devices.note_train_tree_bytes(params=trainer.params, opt_state=trainer.opt_state,
                                   site="parallel_trainer")
    return trainer
