"""Tensor and expert parallelism of ``ParallelTrainer`` over the mesh's
``model`` axis.

The JAX package's ``ParallelTrainer(tensor_parallel=True)`` gives each
parameter a ``PartitionSpec`` (``_layer_param_spec``) and lets GSPMD insert
the collectives, so its step equals the replicated step. Here the same
specs place the parameters and the collectives are explicit:

* each rank of a ``model`` group stores, differentiates and updates only
  its slice of a split leaf: Dense-family ``W``/``Wx``/``Wh`` on the last
  dim, ``b``/``beta``/``gamma`` on dim 0, a conv's HWIO kernel on O, MoE
  ``expert_*`` stacks on the expert dim; a leaf splits only when its dim
  divides by the axis size, and a nested sub-dict (a block's ``ln``/``mha``)
  stays whole unless it is an ``expert_*`` leaf;
* a split ``DenseLayer`` or ``ConvolutionLayer`` with an elementwise
  activation computes its own output columns (channels) and a split
  ``BatchNormalization`` its own channels, with its running statistics of
  those channels (exact: the statistics are per channel). Their input
  enters through ``IdPsumBwd`` (its cotangent is the sum of the ranks'
  partial ones) and the columns leave through ``GatherSliceBwd`` (all-gather
  forward; the backward takes the local slice, since every rank holds the
  same downstream cotangent);
* any other layer with split leaves gathers them whole for its forward
  through ``GatherSliceBwd`` (the backward keeps the local slice of the
  whole, identical, gradient);
* an MoE block's experts run where they live (``nn/layers/moe.py``).

The rules match the JAX module's on every leaf (``make_param_shardings``);
the fused conv-BN vertices have no ``.layer`` and stay whole, as there.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.layers.conv import BatchNormalization, ConvolutionLayer
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.utils import collectives as C
from deeplearning4j_tpu_torch.utils.trees import tree_leaves

#: activations that mix a row's columns: a layer with one cannot compute
#: its columns alone
_MIXING = ("softmax", "logsoftmax")


def layer_param_spec(layer, pname, t):
    """The JAX ``_layer_param_spec`` of one parameter: a ``P``."""
    spec = [None] * t.dim()
    if pname.startswith("expert_"):
        spec[0] = "model"
    elif pname in ("W", "Wx", "Wh") and t.dim() >= 2:
        spec[-1] = "model"
    elif pname in ("b", "beta", "gamma") and t.dim() == 1:
        spec[0] = "model"
    return _mesh.P(*spec)


def layer_param_items(net, params):
    """(layer, key, param tree) of either container: a MultiLayerNetwork's
    list aligned with its layers, a ComputationGraph's dict by vertex (the
    layer is None for a vertex without one)."""
    if isinstance(params, dict):
        def layer_of(name):
            return getattr(getattr(net._defs.get(name), "vertex", None), "layer", None)
        return [(layer_of(name), name, params[name]) for name in params]
    return [(layer, i, p) for i, (layer, p) in enumerate(zip(net.conf.layers, params))]


def _specs(tree, layer, tp, depth=0, name=None):
    if hasattr(tree, "items"):
        return {k: _specs(v, layer, tp, depth + 1, k) for k, v in tree.items()}
    if depth > 1 and not name.startswith("expert_"):
        return _mesh.P()
    spec = layer_param_spec(layer, name, tree)
    ok = all(s is None or tree.shape[i] % tp == 0 for i, s in enumerate(spec))
    return spec if ok else _mesh.P()


def tp_param_specs(mesh, net, params):
    """The tensor-parallel spec tree of ``params`` (the JAX rule)."""
    tp = mesh.shape["model"]
    items = layer_param_items(net, params)
    out = {} if isinstance(params, dict) else [None] * len(items)
    for layer, key, p in items:
        if tp > 1 and layer is not None:
            out[key] = _specs(p, layer, tp)
        else:
            out[key] = _mesh._map_leaves(lambda _: _mesh.P(), p)
    return out


def split_dim(spec):
    """The dim a spec splits over 'model', or None."""
    return next((i for i, e in enumerate(spec) if "model" in _mesh._axes(e)), None)


def _columns_exact(layer, params, split):
    """Whether the split layer can compute its own output columns: one of
    the column layers, an elementwise activation, and every split leaf on
    its output dim."""
    if type(layer) not in (DenseLayer, ConvolutionLayer, BatchNormalization):
        return False
    act = getattr(layer, "activation", "identity")
    if isinstance(act, str) and act.lower() in _MIXING:
        return False
    for k, t in params.items():
        if hasattr(t, "items"):
            return False
        d = split.get(k)
        want = t.dim() - 1 if k in ("W",) else 0
        if d is not None and d != want:
            return False
    return True


def tp_apply(layer, params, state, x, mg, *, split, train=False, **kwargs):
    """``layer.apply`` with the leaves ``split`` ({key: dim}) of ``params``
    split over ``mg`` (see the module docstring). Returns (output, new
    state) equal to the whole layer's."""
    if all(k.startswith("expert_") for k in split):
        # only experts split (a nested sub-dict never is): the MoE block
        # runs its own experts where they live
        return layer.apply(params, state, x, train=train, **kwargs)
    group = mg.group
    if _columns_exact(layer, params, split):
        if x.requires_grad:
            x = C.IdPsumBwd.apply(x, group)
        st = state
        if isinstance(layer, BatchNormalization):
            x = C.local_slice(x, -1, mg.rank, mg.world)
            st = {k: C.local_slice(v, 0, mg.rank, mg.world) for k, v in state.items()}
        y, new_st = layer.apply(params, st, x, train=train, **kwargs)
        y = mg.timed_call("tp_gather", lambda t: C.GatherSliceBwd.apply(t, -1, group), y)
        if isinstance(layer, BatchNormalization) and new_st is not st:
            new_st = {k: C.gather_dim(v.detach(), 0, group) for k, v in new_st.items()}
        elif new_st is st:
            new_st = state
        return y, new_st
    whole = dict(params)
    for k, d in split.items():
        whole[k] = mg.timed_call("tp_weights", lambda t, d=d: C.GatherSliceBwd.apply(t, d, group),
                                 params[k])
    return layer.apply(whole, state, x, train=train, **kwargs)


def split_map(params, specs):
    """{id(leaf): split dim} of the leaves ``specs`` split over 'model'."""
    out = {}
    for t, s in zip(tree_leaves(params), tree_leaves(specs)):
        d = split_dim(s)
        if d is not None:
            out[id(t)] = d
    return out
