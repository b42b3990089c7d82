"""The port's training core against the JAX package.

Losses, updaters, schedules, gradient normalization, constraints and
penalties are compared function by function on the same numpy inputs; the
whole slice (``transformer_lm`` loss, gradients, one Adam step and three
``fit`` steps) from the same JAX checkpoint zip under the f32 policy.

Tolerances: forward and loss atol 1e-5 (the reference's f32 kernel
tolerance, tests/test_ops.py); gradients atol 2e-5 + rtol 2e-4 (the same
sums in another order through a deeper graph); updater state and parameters
after pure update math rtol 1e-5 (the JAX tests run in x64, so its
learning-rate scalars are f64 where the port's are f32). Parameters after
``fit`` atol 1e-4: a parameter whose gradient is zero analytically (the key
bias: softmax is invariant to a shift shared by a row's keys) takes Adam
steps driven by rounding noise, which differs between the two packages.
"""

import dataclasses
import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import iterator as jit_
from deeplearning4j_tpu.models.misc import text_generation_lstm as j_charnn
from deeplearning4j_tpu.models.misc import transformer_lm as j_lm
from deeplearning4j_tpu.nn import constraints as JC
from deeplearning4j_tpu.nn import gradnorm as JG
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import losses as JLoss
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets import iterator as tit
from deeplearning4j_tpu_torch.models.misc import text_generation_lstm as t_charnn
from deeplearning4j_tpu_torch.models.misc import transformer_lm as t_lm
from deeplearning4j_tpu_torch.nn import constraints as TC
from deeplearning4j_tpu_torch.nn import gradnorm as TG
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import losses as TLoss
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn import weightnoise as TWN
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.ops import lstm_seq
from deeplearning4j_tpu_torch.utils import serialization as tser

VOCAB, LAYERS, WIDTH, HEADS, SEQ = 37, 2, 32, 2, 128


def _flat(tree, prefix=""):
    """{keystr path: float64 ndarray} for JAX pytrees and port trees alike."""
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}['{k}']"))
        return out
    if torch.is_tensor(tree):
        return {prefix: tree.detach().double().numpy()}
    return {prefix: np.asarray(tree, np.float64)}


def _assert_trees(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

LOSSES = ["mse", "mae", "xent", "mcxent", "sparse_mcxent", "hinge", "squared_hinge",
          "kl_divergence", "cosine_proximity", "poisson", "mean_squared_log_error",
          "mean_absolute_percentage_error"]


def test_loss_catalog_names_match():
    assert TLoss.names() == JLoss.names()
    assert len(set(TLoss._CATALOG.values())) == len(LOSSES)


def _loss_inputs(name, rs):
    logits = rs.randn(3, 4, 5).astype(np.float32)
    pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = rs.randint(0, 5, size=(3, 4))
    if name == "sparse_mcxent":
        labels = ids.astype(np.float32)
    elif name in ("hinge", "squared_hinge"):
        labels = np.where(rs.rand(3, 4, 5) > 0.5, 1.0, -1.0).astype(np.float32)
        pred = logits
    elif name in ("mse", "mae", "cosine_proximity", "mean_absolute_percentage_error"):
        labels, pred = rs.randn(3, 4, 5).astype(np.float32), logits
    else:
        labels = np.eye(5, dtype=np.float32)[ids]
        labels[0, 0] = [0.1, 0.2, 0.3, 0.4, 0.0]  # one soft label row
    return pred, labels


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_gradient_match_jax(name, masked):
    rs = np.random.RandomState(len(name))
    pred, labels = _loss_inputs(name, rs)
    mask = None
    if masked:
        mask = (rs.rand(3, 4) > 0.3).astype(np.float32)
        mask[1] = 0.0
    jf, tf = JLoss.get(name), TLoss.get(name)
    jm = None if mask is None else jnp.asarray(mask)
    want, want_g = jax.value_and_grad(lambda p: jf(p, jnp.asarray(labels), jm))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tf(p, torch.from_numpy(labels), None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)


def test_mcxent_clips_probabilities_and_masks_with_floor():
    pred = torch.tensor([[0.0, 1.0], [0.5, 0.5]], requires_grad=True)
    labels = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    loss = TLoss.mcxent(pred, labels, torch.tensor([1.0, 0.0]))
    np.testing.assert_allclose(float(loss.detach()), -np.log(1e-8), rtol=1e-6)
    loss.backward()
    assert pred.grad[0, 0] == 0  # the clip bites: no gradient through it
    # an all-zero mask divides by max(sum, 1), not 0
    assert float(TLoss.mcxent(pred, labels, torch.zeros(2))) == 0.0


# ---------------------------------------------------------------------------
# updaters and schedules
# ---------------------------------------------------------------------------

def _params_np(rs):
    return [{"W": rs.randn(3, 4), "b": rs.randn(4)}, {},
            {"ln": {"gamma": rs.randn(4)}, "W2": rs.randn(4, 2)}]


def _cast(tree, fn):
    if isinstance(tree, list):
        return [_cast(v, fn) for v in tree]
    return {k: _cast(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


UPDATERS = [("Sgd", {}), ("Nesterovs", {}), ("Adam", {}), ("AdaMax", {}), ("Nadam", {}),
            ("AdaGrad", {}), ("AdaDelta", {}), ("RmsProp", {}), ("AmsGrad", {}), ("NoOp", {}),
            ("Adam", {"learning_rate": ("ExponentialSchedule", {"initial": 0.01,
                                                               "gamma": 0.5})})]


@pytest.mark.parametrize("name,kwargs", UPDATERS)
def test_updater_three_steps_match_jax(name, kwargs):
    def make(mod):
        kw = {k: getattr(mod, v[0])(**v[1]) if isinstance(v, tuple) else v
              for k, v in kwargs.items()}
        return getattr(mod, name)(**kw)
    ju, tu = make(JU), make(TU)
    rs = np.random.RandomState(7)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    p_np = _cast(_params_np(rs), f32)
    jp = _cast(p_np, jnp.asarray)
    tp = _cast(p_np, lambda a: torch.from_numpy(a.copy()))
    js, ts = ju.init(jp), tu.init(tp)
    for step in range(3):
        g_np = _cast(_params_np(rs), f32)
        upd, js = ju.update(_cast(g_np, jnp.asarray), js, jp, step)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        ts = tu.update_(tp, _cast(g_np, torch.from_numpy), ts, step)
    _assert_trees(tp, jp, rtol=1e-5, atol=1e-7)
    _assert_trees(ts, js, rtol=1e-5, atol=1e-9)


SCHEDULES = [("FixedSchedule", {"value": 0.3}),
             ("ExponentialSchedule", {"initial": 0.2, "gamma": 0.97}),
             ("InverseSchedule", {"initial": 0.2, "gamma": 0.05, "power": 0.75}),
             ("PolySchedule", {"initial": 0.2, "power": 2.0, "max_iter": 1000}),
             ("SigmoidSchedule", {"initial": 0.2, "gamma": 0.03, "step_size": 200}),
             ("StepSchedule", {"initial": 0.2, "decay_rate": 0.5, "step_size": 100}),
             ("WarmupCosineSchedule", {"peak": 1e-3, "warmup_steps": 50,
                                       "total_steps": 1000, "floor": 1e-5})]


@pytest.mark.parametrize("name,kwargs", SCHEDULES)
def test_schedule_matches_jax(name, kwargs):
    js, ts = getattr(JU, name)(**kwargs), getattr(TU, name)(**kwargs)
    for step in (0, 1, 7, 49, 50, 150, 999, 5000):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(TU.resolve_lr(ts, step), float(JU.resolve_lr(js, step)),
                                   rtol=1e-6)
    assert TU.resolve_lr(0.25, 3) == float(JU.resolve_lr(0.25, 3))


# ---------------------------------------------------------------------------
# gradient normalization, constraints, penalties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "renormalize_l2_per_layer",
                                  "renormalize_l2_per_param_type",
                                  "clip_elementwise_absolute_value", "clip_l2_per_layer",
                                  "clip_l2_per_param_type"])
def test_gradnorm_matches_jax(mode):
    rs = np.random.RandomState(3)
    g = [{"W": rs.randn(3, 4).astype(np.float32), "b": rs.randn(4).astype(np.float32)}, {},
         {"W": 0.01 * rs.randn(4, 2).astype(np.float32)}]
    want = JG.normalize_grads(mode, _cast(g, jnp.asarray), threshold=0.5)
    got = TG.normalize_grads(mode, _cast(g, torch.from_numpy), threshold=0.5)
    _assert_trees(got, want, rtol=1e-6, atol=1e-7)


def test_gradnorm_per_layer_covers_nested_trees():
    g = [{"ln": {"gamma": torch.full((4,), 3.0)}, "W": torch.full((2,), 4.0)}]
    out = TG.normalize_grads("renormalize_l2_per_layer", g)
    total = torch.sqrt(sum((v * v).sum() for v in (out[0]["ln"]["gamma"], out[0]["W"])))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-6)


@pytest.mark.parametrize("make", [
    lambda M: M.MaxNormConstraint(max_norm=0.5),
    lambda M: M.MinMaxNormConstraint(min_norm=0.8, max_norm=1.5, rate=0.7),
    lambda M: M.NonNegativeConstraint(),
    lambda M: M.UnitNormConstraint(apply_to="weights"),
    lambda M: M.MaxNormConstraint(max_norm=0.1, apply_to="biases"),
], ids=["maxnorm", "minmaxnorm", "nonnegative", "unitnorm", "maxnorm_biases"])
def test_constraints_match_jax(make):
    rs = np.random.RandomState(9)
    p = {"W": rs.randn(5, 3).astype(np.float32), "b": rs.randn(3).astype(np.float32)}
    jl = JL.DenseLayer(n_out=3, constraints=(make(JC),))
    tl = TL.DenseLayer(n_out=3, constraints=(make(TC),))
    want = jl.apply_constraints({k: jnp.asarray(v) for k, v in p.items()}, 0, 0)
    got = tl.apply_constraints({k: torch.from_numpy(v.copy()) for k, v in p.items()}, 0, 0)
    _assert_trees(got, want, rtol=1e-6, atol=1e-7)


def test_constraint_configs_round_trip_through_json():
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
    from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration as TConf
    j_json = JConf().list(JL.OutputLayer(n_out=2, constraints=(JC.MaxNormConstraint(1.5),)),
                          input_type=JI.FeedForwardType(3)).to_json()
    conf = TConf.from_json(j_json)
    assert isinstance(conf.layers[0].constraints[0], TC.MaxNormConstraint)
    assert conf.to_json() == j_json


def test_regularization_penalty_matches_jax():
    rs = np.random.RandomState(2)
    p = {"W": rs.randn(5, 3).astype(np.float32), "b": rs.randn(3).astype(np.float32)}
    kw = dict(n_out=3, l1=0.01, l2=0.02, l1_bias=0.003, l2_bias=0.004)
    want = JL.DenseLayer(**kw).regularization_penalty({k: jnp.asarray(v) for k, v in p.items()})
    got = TL.DenseLayer(**kw).regularization_penalty({k: torch.from_numpy(v)
                                                      for k, v in p.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert TL.TransformerBlock(n_out=4).regularization_penalty({}) == 0.0


def test_pop_aux_losses():
    from deeplearning4j_tpu_torch.nn.layers.base import pop_aux_losses
    loss, states = pop_aux_losses(torch.tensor(1.0), [{}, {"aux_loss": torch.tensor(0.5),
                                                            "k": 1}])
    assert float(loss) == 1.5 and states == [{}, {"k": 1}]


@pytest.mark.parametrize("ids3", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_embedding_sequence_matches_jax(ids3, masked):
    jl = JL.EmbeddingSequenceLayer(n_in=11, n_out=6, add_positional=True)
    tl = TL.EmbeddingSequenceLayer(n_in=11, n_out=6, add_positional=True)
    p = {k: np.asarray(v, np.float32) for k, v in
         jl.init(jax.random.PRNGKey(0), JI.RecurrentType(1, 9), jnp.float32).items()}
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 11, size=(2, 7)).astype(np.float32)
    x = ids[..., None] if ids3 else ids
    m = (rs.rand(2, 7) > 0.3).astype(np.float32) if masked else None
    want, _ = jl.apply({k: jnp.asarray(v) for k, v in p.items()}, {}, jnp.asarray(x),
                       mask=None if m is None else jnp.asarray(m))
    got, _ = tl.apply({k: torch.from_numpy(v) for k, v in p.items()}, {}, torch.from_numpy(x),
                      mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


# ---------------------------------------------------------------------------
# minibatch plumbing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_target", [None, 6])
@pytest.mark.parametrize("with_mask", [False, True])
def test_pad_batch_matches_jax(with_mask, seq_target):
    rs = np.random.RandomState(0)
    x, y = rs.randn(3, 4, 2).astype(np.float32), rs.randn(3, 4, 5).astype(np.float32)
    m = (rs.rand(3, 4) > 0.5).astype(np.float32) if with_mask else None
    want = jit_.pad_batch(x, y, m, 5, seq_target=seq_target)
    for wrap in (np.asarray, torch.from_numpy):
        got = tit.pad_batch(wrap(x), wrap(y), None if m is None else wrap(m), 5,
                            seq_target=seq_target)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tit.validity_mask(y[:, 0], 2, 4),
                                  jit_.validity_mask(y[:, 0], 2, 4))


def test_iter_batches_matches_jax():
    rs = np.random.RandomState(1)
    x, y, m = rs.randn(7, 3), rs.randn(7, 2), rs.rand(7)
    for args in (((x, y), None, 3, None), (x, y, 3, m), ((x, y), None, None, None)):
        for pad in (None, True):
            want = list(jit_.iter_batches(*args, pad_to=pad))
            got = list(tit.iter_batches(*args, pad_to=pad))
            assert len(got) == len(want)
            for gb, wb in zip(got, want):
                for a, b in zip(gb, wb):
                    if b is None:
                        assert a is None
                    else:
                        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    items = [{"features": x[:2], "labels": y[:2]}, (x[2:4], y[2:4]), (x[4:], y[4:], m[4:])]
    got = list(tit.iter_batches(iter(items)))
    assert [g[0].shape[0] for g in got] == [2, 2, 3] and got[2] is items[2]


# ---------------------------------------------------------------------------
# the whole slice: transformer_lm from one JAX zip
# ---------------------------------------------------------------------------

def _lm_data(n, seed):
    """Token sequences with a learnable rule: ids[t+1] = (5 ids[t] + 3) mod V."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((n, SEQ + 1), np.int64)
    ids[:, 0] = rs.randint(0, VOCAB, size=n)
    for t in range(SEQ):
        ids[:, t + 1] = (5 * ids[:, t] + 3) % VOCAB
    x = ids[:, :SEQ, None].astype(np.float32)
    y = np.eye(VOCAB, dtype=np.float32)[ids[:, 1:]]
    return x, y


@pytest.fixture(scope="module")
def lm_zip(tmp_path_factory):
    net = JNet(j_lm(VOCAB, n_layers=LAYERS, d_model=WIDTH, n_heads=HEADS, seq_len=SEQ))
    net.init()
    path = tmp_path_factory.mktemp("lm") / "lm.zip"
    jser.save_model(net, str(path))
    return path


@pytest.fixture(params=["flash", "naive"])
def attention_path(request, monkeypatch):
    """The port's attention branch: flash (plain forward + blockwise
    backward on the CPU) or naive. The JAX package runs naive on the CPU."""
    monkeypatch.setenv("DL4J_TPU_FUSED_ATTENTION_MIN_SEQ",
                       "0" if request.param == "flash" else "1000000")
    return request.param


def test_transformer_lm_config_and_full_width_count():
    conf = t_lm(VOCAB, n_layers=LAYERS, d_model=WIDTH, n_heads=HEADS, seq_len=SEQ)
    assert conf.to_json() == j_lm(VOCAB, n_layers=LAYERS, d_model=WIDTH, n_heads=HEADS,
                                  seq_len=SEQ).to_json()
    big = dict(n_layers=6, d_model=512, n_heads=8, seq_len=4096)
    jnet = JNet(j_lm(8192, **big))
    shapes = jax.eval_shape(jnet.init)[0]
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    tnet = TNet(t_lm(8192, **big), device="cpu")
    tnet.init()
    assert tnet.num_params() == want == 29_408_256


def test_loss_gradients_and_adam_step_match_jax(lm_zip, attention_path):
    jnet = jser.load_model(str(lm_zip))
    tnet = tser.load_model(lm_zip, device="cpu")
    x, y = _lm_data(3, seed=1)
    loss_j, _, grads_j = jnet.compute_gradients(jnet.params, jnet.state, jnp.asarray(x),
                                                jnp.asarray(y))
    loss_t, _, grads_t = tnet.compute_gradients(tnet.params, tnet.state, torch.from_numpy(x),
                                                torch.from_numpy(y))
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-5)
    np.testing.assert_allclose(tnet.score(x, y), float(jnet.score(x, y)), atol=1e-5)
    _assert_trees(grads_t, grads_j, atol=2e-5, rtol=2e-4)
    # one Adam step from the JAX gradients: the update math alone
    grads_from_j = _cast([{k: v for k, v in g.items()} for g in grads_j],
                         lambda a: torch.from_numpy(np.array(a, np.float32)))
    params_j, opt_j = jnet.apply_update(jnet.params, jnet.conf.updater.init(jnet.params),
                                        grads_j, 0)
    opt_t = tnet.conf.updater.init(tnet.params)
    tnet.apply_update(tnet.params, opt_t, grads_from_j, 0)
    _assert_trees(tnet.params, params_j, rtol=1e-5, atol=1e-7)
    _assert_trees(opt_t, opt_j, rtol=1e-5, atol=1e-12)


def test_three_fit_steps_match_jax(lm_zip, attention_path):
    jnet = jser.load_model(str(lm_zip))
    tnet = tser.load_model(lm_zip, device="cpu")
    x, y = _lm_data(6, seed=2)
    jnet.fit((x, y), batch_size=2)
    tnet.fit((x, y), batch_size=2)
    assert tnet.iteration == jnet.iteration == 3 and tnet.epoch == jnet.epoch == 1
    assert len(tnet.score_history) == 3
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value), atol=1e-5)
    _assert_trees(tnet.params, jnet.params, atol=1e-4)
    _assert_trees(tnet.opt_state["m"], jnet.opt_state["m"], atol=2e-6)


def test_adam_state_round_trips_and_resumes(lm_zip, tmp_path):
    jnet = jser.load_model(str(lm_zip))
    x, y = _lm_data(4, seed=3)
    jnet.fit((x, y), batch_size=2)
    mid = tmp_path / "mid.zip"
    jser.save_model(jnet, str(mid))
    tnet = tser.load_model(mid, device="cpu")
    assert tnet.iteration == 2
    _assert_trees(tnet.opt_state, jnet.opt_state, rtol=0, atol=0)
    back = tmp_path / "back.zip"
    tser.save_model(tnet, back)
    arrays = [dict(np.load(io.BytesIO(zipfile.ZipFile(p).read("arrays.npz"))))
              for p in (mid, back)]
    assert set(arrays[0]) == set(arrays[1])
    assert any(k.startswith("opt['v'][1]['mha']") for k in arrays[1])
    for k, v in arrays[0].items():
        np.testing.assert_array_equal(arrays[1][k], v, err_msg=k)
    # resume one step in each package from the same mid-training zip
    jback = jser.load_model(str(back))
    x2, y2 = _lm_data(2, seed=4)
    jback.fit((x2, y2))
    tnet.fit((x2, y2))
    _assert_trees(tnet.params, jback.params, atol=1e-4)
    assert tnet.iteration == jback.iteration == 3


def test_char_rnn_gradients_on_the_cpu_match_jax():
    """A GravesLSTM net trains on the CPU through the differentiable plain
    sequence op."""
    jnet = JNet(j_charnn(11, hidden=16, seq_len=6))
    jnet.init()
    tnet = TNet(t_charnn(11, hidden=16, seq_len=6), device="cpu")
    tser.params_from_numpy(tnet, [{k: np.asarray(v) for k, v in p.items()}
                                  for p in jnet.params])
    rs = np.random.RandomState(0)
    x = np.eye(11, dtype=np.float32)[rs.randint(0, 11, size=(3, 6))]
    y = np.eye(11, dtype=np.float32)[rs.randint(0, 11, size=(3, 6))]
    loss_j, _, g_j = jnet.compute_gradients(jnet.params, jnet.state, jnp.asarray(x),
                                            jnp.asarray(y))
    loss_t, _, g_t = tnet.compute_gradients(tnet.params, tnet.state, torch.from_numpy(x),
                                            torch.from_numpy(y))
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-5)
    _assert_trees(g_t, g_j, atol=2e-5, rtol=2e-4)


# ---------------------------------------------------------------------------
# what training refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", [{"dropout": 0.1}, {"weight_noise": TWN.WeightNoise()}],
                         ids=["dropout", "weight_noise"])
def test_dropout_and_weight_noise_raise_in_train_mode(change):
    """Input dropout and weight noise both train: the step differs from the
    plain step from the same weights and repeats to the bit from the same
    seed and iteration. Inference ignores both."""
    conf = t_lm(VOCAB, n_layers=1, d_model=8, n_heads=2, seq_len=8)

    def net_with(ch):
        layers = conf.layers[:-1] + (dataclasses.replace(conf.layers[-1], **ch),)
        net = TNet(dataclasses.replace(conf, layers=layers), device="cpu")
        net.init()
        return net

    net = net_with(change)
    rs = np.random.RandomState(0)
    x = rs.randint(0, VOCAB, (2, 8, 1)).astype(np.float32)
    y = np.eye(VOCAB, dtype=np.float32)[rs.randint(0, VOCAB, (2, 8))]
    plain, again = net_with({}), net_with(change)
    for n in (net, plain, again):
        n.fit((x, y))
    _assert_trees(again.params, net.params, rtol=0, atol=0)
    assert not torch.equal(net.params[-1]["W"], plain.params[-1]["W"])
    assert np.isfinite(net.score_value)
    assert net.output(x).shape == (2, 8, VOCAB)  # inference ignores both
    np.testing.assert_array_equal(net.output(x).numpy(), net.output(x).numpy())


def test_tbptt_raises():
    """Truncated BPTT no longer raises: a sequence longer than the window
    trains in chunks, one iteration a chunk, one score a batch."""
    net = TNet(t_charnn(5, hidden=4, seq_len=3), device="cpu")
    rs = np.random.RandomState(0)
    x = np.eye(5, dtype=np.float32)[rs.randint(0, 5, size=(2, 7))]
    net.fit((x, x))
    assert net.iteration == 3  # chunks of 3, 3 and 1 steps
    assert len(net.score_history) == 1 and np.isfinite(net.score_value)


def test_lstm_kernel_refuses_autograd_on_the_card():
    """The refusal is gone: gradients flow through the LSTM Function (its
    forward the plain version on CPU tensors, its backward lstm_seq_bwd),
    the path the kernel takes on the card."""
    assert not hasattr(lstm_seq, "refuse_autograd")
    layer = TL.GravesLSTM(n_out=4)
    params = {k: v.requires_grad_(True) for k, v in
              layer.init(torch.Generator().manual_seed(0), TI.RecurrentType(3, 5)).items()}
    y, _ = layer.apply(params, {}, torch.randn(2, 5, 3))
    assert y.grad_fn is not None and "LstmSeqFunction" in repr(y.grad_fn.next_functions)
    y.sum().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in params.values())
