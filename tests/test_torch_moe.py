"""The port's Mixture-of-Experts block against the JAX package.

``MoETransformerBlock`` (nn/layers/moe.py) at the JAX tests' widths (d 16,
2 heads, 4 experts, T 8, batch 4), on numpy inputs, with the JAX layer's
parameters carried across: forward in eval and train mode, the stashed aux
term, gradients of output + aux with respect to every parameter and the
input, the routing and keep decisions, capacity overflow, a TBPTT fit, a
ComputationGraph LayerVertex, the config JSON and zip v1 in both
directions, and the port's gather/scatter dispatch against a one-hot einsum
dispatch (the JAX package's form) written here.

Tolerances: forward and aux atol 1e-5 (the reference's f32 tolerance,
tests/test_ops.py); gradients rtol 1e-4 + atol 1e-5 (the same sums in
another order); the dispatch forms agree to f32 rounding (atol 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import graph as JG
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JNetConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.nn import graph as TG
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig as TNetConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.utils import serialization as tser

D, T, E, BATCH, VOCAB = 16, 8, 4, 4, 20
ATOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5


def _block(L, **kw):
    return L.MoETransformerBlock(**{"n_out": D, "n_heads": 2, "n_experts": E, "causal": True,
                                    **kw})


def _jax_block(seed=0, **kw):
    """The JAX layer and its f32 parameters."""
    layer = _block(JL, **kw)
    params = layer.init(jax.random.PRNGKey(seed), JI.RecurrentType(D, T), jnp.float32)
    return layer, params


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _flat(tree, prefix=""):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if torch.is_tensor(tree):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _x(seed=1):
    return np.random.RandomState(seed).randn(BATCH, T, D).astype(np.float32)


def _conf(M, L, I, U, capacity_factor=8.0, aux_w=0.01, **kw):
    return M(seed=3, updater=U.Adam(learning_rate=1e-2)).list(
        L.EmbeddingSequenceLayer(n_in=VOCAB, n_out=D, add_positional=True),
        _block(L, capacity_factor=capacity_factor, aux_loss_weight=aux_w),
        L.RnnOutputLayer(n_out=VOCAB, loss="mcxent"),
        input_type=I.RecurrentType(1, T), **kw)


def _data(batch=BATCH, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (batch, T))
    return ids[..., None].astype(np.float32), np.eye(VOCAB, dtype=np.float32)[np.roll(ids, -1, 1)]


def _nets(**kw):
    """The JAX net and the port's net with the JAX net's parameters."""
    jnet = JNet(_conf(JNetConf, JL, JI, JU, **kw))
    jnet.init()
    tnet = TNet(_conf(TNetConf, TL, TI, TU, **kw), device="cpu")
    tser.params_from_numpy(tnet, jnet.params)
    return jnet, tnet


def _jax_routing(params, h2d, cap):
    """top and keep [N] from the JAX block's math (moe.py:102-110)."""
    logits = jnp.asarray(h2d) @ params["router_W"].astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(top, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot, axis=0) * onehot - 1.0
    keep = ((pos >= 0) & (pos < cap)).any(axis=-1)
    return np.asarray(top), np.asarray(keep)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_moe_block_forward_and_aux_match_jax(train):
    layer, jp = _jax_block()
    x = _x()
    jy, jstate = layer.apply(jp, {}, jnp.asarray(x), train=train)
    tlayer = _block(TL)
    ty, tstate = tlayer.apply(_torch(jp), {}, torch.from_numpy(x), train=train)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=ATOL)
    assert set(tstate) == set(jstate) == ({"aux_loss"} if train else set())
    if train:
        np.testing.assert_allclose(float(tstate["aux_loss"]), float(jstate["aux_loss"]),
                                   atol=1e-5)
        assert float(tstate["aux_loss"]) >= 0.01 * 0.99  # E * sum f p >= 1 at balance


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_block_gradients_match_jax(capacity_factor):
    """d(sum(y * g) + aux) / d(every parameter, x): the router learns
    through the gate and the aux term only."""
    layer, jp = _jax_block(capacity_factor=capacity_factor)
    x = _x()
    g = np.random.RandomState(2).randn(BATCH, T, D).astype(np.float32)

    def j_loss(p, xx):
        y, s = layer.apply(p, {}, xx, train=True)
        return jnp.sum(y * g) + s["aux_loss"]
    jgp, jgx = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(x))

    tlayer = _block(TL, capacity_factor=capacity_factor)
    tp = _torch(jp)
    leaves = list(_flat_tensors(tp))
    for t in leaves:
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, s = tlayer.apply(tp, {}, tx, train=True)
    ((y * torch.from_numpy(g)).sum() + s["aux_loss"]).backward()
    got = _flat(_grads(tp))
    want = _flat(jgp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    assert np.abs(got["/router_W"]).max() > 0


def _flat_tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flat_tensors(v)
        else:
            yield v


def _grads(tree):
    return {k: _grads(v) if isinstance(v, dict) else v.grad for k, v in tree.items()}


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 0.01])
def test_moe_routing_and_keep_match_jax(capacity_factor):
    """Routing decisions first: the chosen expert and whether the token
    fits in its expert's capacity, from the same numpy ln2 output."""
    layer, jp = _jax_block(capacity_factor=capacity_factor)
    h2d = np.random.RandomState(5).randn(BATCH * T, D).astype(np.float32)
    tlayer = _block(TL, capacity_factor=capacity_factor)
    cap = tlayer.capacity(BATCH * T)
    assert cap == int(-(-BATCH * T // E) * capacity_factor) or 1
    r = tlayer.route(_torch(jp), torch.from_numpy(h2d))
    top, keep = _jax_routing(jp, h2d, cap)
    np.testing.assert_array_equal(r.top.numpy(), top)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    # every kept token owns one slot of its expert; the dropped share the spare
    slots = r.slot.numpy()
    kept = slots[keep]
    assert len(set(kept.tolist())) == len(kept) and (kept // cap == top[keep]).all()
    assert (slots[~keep] == E * cap).all()


def test_moe_argmax_takes_the_first_maximum_on_a_tie():
    tlayer = _block(TL)
    params = {"router_W": torch.zeros(D, E)}  # every probability ties at 1/E
    r = tlayer.route(params, torch.ones(BATCH * T, D))
    assert (r.top == 0).all()
    np.testing.assert_array_equal(r.keep.numpy(), np.arange(BATCH * T) < tlayer.capacity(BATCH * T))


def test_moe_gather_dispatch_equals_one_hot_einsum_dispatch():
    """The port's index dispatch and combine against the JAX package's
    dense [N, E, C] one-hot einsums, written here in torch."""
    tlayer = _block(TL, capacity_factor=0.75)
    _, jp = _jax_block(seed=4, capacity_factor=0.75)
    p = _torch(jp)
    x2d = torch.from_numpy(np.random.RandomState(6).randn(BATCH * T, D).astype(np.float32))
    y, aux = tlayer.moe_mlp(p, x2d)

    n, cap = x2d.shape[0], tlayer.capacity(x2d.shape[0])
    probs = torch.softmax(x2d @ p["router_W"], dim=-1)
    onehot = torch.nn.functional.one_hot(probs.argmax(-1), E).float()
    pos = torch.cumsum(onehot, 0) * onehot - 1.0
    keep = (pos >= 0) & (pos < cap)
    dispatch = torch.nn.functional.one_hot(pos.clamp(0, cap - 1).long(), cap).float() \
        * keep[..., None]
    combine = dispatch * (probs * onehot).sum(-1)[:, None, None]
    xe = torch.einsum("nec,nd->ecd", dispatch, x2d)
    h = torch.nn.functional.gelu(torch.einsum("ecd,edh->ech", xe, p["expert_W1"])
                                 + p["expert_b1"][:, None], approximate="tanh")
    ye = torch.einsum("ech,ehd->ecd", h, p["expert_W2"]) + p["expert_b2"][:, None]
    want = torch.einsum("nec,ecd->nd", combine, ye)
    assert keep.any(-1).sum() < n  # some tokens overflow
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-6)
    want_aux = E * (onehot.mean(0) * probs.mean(0)).sum()
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_moe_block_params_and_init_layout_match_jax():
    layer, jp = _jax_block()
    tp = _block(TL).init(torch.Generator().manual_seed(0), TI.RecurrentType(D, T))
    assert list(tp) == list(jp)
    got, want = _flat(tp), _flat(jp)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert _block(TL).regularization_penalty(tp) == 0.0


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

def test_moe_lm_loss_and_gradients_match_jax():
    """The slice as a whole: the MoE LM's loss (aux included) and every
    gradient from the same parameters."""
    jnet, tnet = _nets()
    x, y = _data()
    jl, _, jg = jnet.compute_gradients(jnet.params, jnet.state, jnp.asarray(x), jnp.asarray(y),
                                       rng=jax.random.PRNGKey(0))
    tl, tstate, tg = tnet.compute_gradients(tnet.params, tnet.state, torch.from_numpy(x),
                                            torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert all("aux_loss" not in s for s in tstate)
    for i, (a, b) in enumerate(zip(tg, jg)):
        got, want = _flat(a), _flat(b)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"layer {i}{k}")


def test_moe_aux_weight_shifts_the_loss_by_the_balancing_term():
    x, y = _data()
    scores = []
    for aux_w in (0.0, 1.0):
        jnet, tnet = _nets(aux_w=aux_w)
        scores.append(float(tnet.loss_fn(tnet.params, tnet.state, torch.from_numpy(x),
                                         torch.from_numpy(y), train=True)[0]))
    assert scores[1] - scores[0] >= 0.99


def test_moe_capacity_overflow_matches_jax():
    """capacity_factor 0.01: one slot an expert, most tokens on the residual."""
    jnet, tnet = _nets(capacity_factor=0.01)
    x, _ = _data()
    out = tnet.output(x).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(jnet.output(x)), atol=ATOL)
    assert tnet.conf.layers[1].capacity(BATCH * T) == 1


def test_moe_fit_steps_match_jax():
    jnet, tnet = _nets()
    x, y = _data()
    for _ in range(3):
        jnet.fit(x, y)
        tnet.fit(x, y)
        np.testing.assert_allclose(tnet.score_value, float(jnet.score_value), rtol=1e-4)
    assert tnet.state == [{}, {}, {}]


def test_moe_tbptt_fit_pops_aux_and_keeps_the_state_structure():
    kw = dict(backprop_type="tbptt", tbptt_fwd_length=4, tbptt_back_length=4)
    jconf = dataclasses.replace(_conf(JNetConf, JL, JI, JU), **kw)
    tconf = dataclasses.replace(_conf(TNetConf, TL, TI, TU), **kw)
    jnet = JNet(jconf)
    jnet.init()
    tnet = TNet(tconf, device="cpu")
    tser.params_from_numpy(tnet, jnet.params)
    x, y = _data()
    for _ in range(2):
        jnet.fit(x, y)  # T = 8 > 4: two chunks a batch
        tnet.fit(x, y)
        assert np.isfinite(tnet.score_value)
        np.testing.assert_allclose(tnet.score_value, float(jnet.score_value), rtol=1e-4)
        assert tnet.state == [{}, {}, {}]
    assert tnet.iteration == jnet.iteration == 4


def test_moe_block_as_graph_layer_vertex_matches_jax():
    def graph(G, L, I, U):
        return (G.GraphBuilder(updater=U.Adam(learning_rate=1e-2)).add_inputs("ids")
                .set_input_types(I.RecurrentType(1, T))
                .add_layer("emb", L.EmbeddingSequenceLayer(n_in=VOCAB, n_out=D,
                                                           add_positional=True), "ids")
                .add_layer("moe", _block(L, capacity_factor=1.25), "emb")
                .add_layer("out", L.RnnOutputLayer(n_out=VOCAB, loss="mcxent"), "moe")
                .set_outputs("out").build())
    jconf = graph(JG, JL, JI, JU)
    tconf = TG.GraphConfiguration.from_json(jconf.to_json())
    assert tconf.to_json() == jconf.to_json()
    jnet = JG.ComputationGraph(jconf)
    jnet.init()
    tnet = TG.ComputationGraph(tconf, device="cpu")
    tser.params_from_numpy(tnet, jnet.params)
    x, y = _data()
    np.testing.assert_allclose(tnet.output({"ids": x}).numpy(),
                               np.asarray(jnet.output({"ids": x})), atol=ATOL)
    jl = jnet.loss_fn(jnet.params, jnet.state, {"ids": jnp.asarray(x)}, {"out": jnp.asarray(y)},
                      train=True, rng=jax.random.PRNGKey(0))[0]
    tl = tnet.loss_fn(tnet.params, tnet.state, {"ids": torch.from_numpy(x)},
                      {"out": torch.from_numpy(y)}, train=True)[0]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    tnet.fit({"ids": x}, {"out": y})
    assert "aux_loss" not in tnet.state["moe"]


# ---------------------------------------------------------------------------
# config and checkpoints across the packages
# ---------------------------------------------------------------------------

def test_moe_config_json_round_trips_both_ways():
    j_json = _conf(JNetConf, JL, JI, JU, capacity_factor=1.5, aux_w=0.02).to_json()
    assert TConf.from_json(j_json).to_json() == j_json
    t_json = _conf(TNetConf, TL, TI, TU, capacity_factor=1.5, aux_w=0.02).to_json()
    assert t_json == j_json
    assert JConf.from_json(t_json).to_json() == t_json
    assert [f.name for f in dataclasses.fields(JL.MoETransformerBlock)] == \
        [f.name for f in dataclasses.fields(TL.MoETransformerBlock)]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_moe_zip_restores_across_packages(direction, tmp_path):
    """A zip v1 the one package saves (with its updater state after a fit)
    restores in the other: the stacked experts and the nested dicts."""
    x, y = _data()
    path = tmp_path / "moe.zip"
    if direction == "jax_to_torch":
        src = JNet(_conf(JNetConf, JL, JI, JU))
        src.init()
        src.fit(x, y)
        jser.save_model(src, str(path))
        dst = tser.load_model(str(path), device="cpu")
        out_src, out_dst = np.asarray(src.output(x)), dst.output(x).numpy()
    else:
        src = TNet(_conf(TNetConf, TL, TI, TU), device="cpu")
        src.init(torch.Generator().manual_seed(0))
        src.fit(x, y)
        tser.save_model(src, str(path))
        dst = jser.load_model(str(path))
        out_src, out_dst = src.output(x).numpy(), np.asarray(dst.output(x))
    for a, b in zip(src.params, dst.params):
        fa, fb = _flat(a), _flat(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)
    assert _flat(dst.params[1])["/expert_W1"].shape == (E, D, 4 * D)
    np.testing.assert_allclose(out_dst, out_src, atol=ATOL)


def test_moe_fit_k4_dispatches_equal_k1_steps():
    """K=4 steps a dispatch (``nn/fused.py``, run eagerly on the CPU) give
    the K=1 fit's losses and parameters to the bit: the block's shapes are
    static and the aux term is popped inside each step."""
    x, y = _data(batch=8 * BATCH, seed=7)
    nets = []
    for k in (1, 4):
        _, tnet = _nets()
        tnet.fit(x, y, batch_size=BATCH, steps_per_dispatch=k)
        nets.append(tnet)
    assert nets[1].score_history == nets[0].score_history
    assert nets[1].iteration == nets[0].iteration == 8
    for a, b in zip(nets[0].params, nets[1].params):
        fa, fb = _flat(a), _flat(b)
        for key in fa:
            np.testing.assert_array_equal(fb[key], fa[key], err_msg=key)
    assert nets[1].state == [{}, {}, {}]
