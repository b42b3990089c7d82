"""The VariationalAutoencoder and the full-batch solvers against the JAX
package, in float64 (the JAX tests run x64).

The VAE: config serde of every reconstruction distribution, the
parameter layout and count, encode/decode/reconstruct/generate, the
-ELBO and its gradients under each of the five distributions with the
same standard-normal draws injected into both packages (the JAX
package's own threefry draws, replayed: the port draws from a
``torch.Generator`` instead), ``reconstruction_probability``, the
Bernoulli clip's gradient where it bites, and the layer inside a network.
The solvers: ``backtrack_line_search`` on accepting, interpolating,
scaled and failing searches, the first three iterations of each
optimizer, and ``Solver`` on a tiny network (dropout off: the port's
dropout bits differ by design); the line search makes no host read and
an iteration one.

Tolerances: losses, gradients and parameters rtol 1e-9 and atol 1e-12
(the same float64 arithmetic in another order: the solvers' line search
amplifies rounding in the interpolation); the count and layout exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import solvers as js
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serde as jserde
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import solvers as ts
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf.memory import memory_report
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration as TMLC
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig as TConf
from deeplearning4j_tpu_torch.nn.layers import vae as tvae
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.utils import serde as tserde
from deeplearning4j_tpu_torch.utils.gradcheck import check_gradients
from deeplearning4j_tpu_torch.utils.serialization import params_from_numpy

TOL = dict(rtol=1e-9, atol=1e-12)


def _np(t):
    return t.detach().double().cpu().numpy() if torch.is_tensor(t) else np.asarray(t, np.float64)


def _dists(L):
    return {
        "gaussian": "gaussian",
        "bernoulli": "bernoulli",
        "exponential": L.ExponentialReconstruction(activation="softplus"),
        "composite": L.CompositeReconstruction(parts=(
            (2, L.GaussianReconstruction(activation="tanh")), (3, L.BernoulliReconstruction()))),
        "loss_wrapper": L.LossWrapperReconstruction(loss="mse", activation="sigmoid"),
    }


def _vae(L, dist, **kw):
    return L.VariationalAutoencoder(n_latent=2, encoder_layer_sizes=(6, 4),
                                    decoder_layer_sizes=(5,), reconstruction=_dists(L)[dist],
                                    activation="tanh", **kw)


def _jax_eps(key, shape, n):
    """The draws JAX ``pretrain_loss`` makes from ``key``: one split each."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float64))))
    return out


def _params(jl, n_in, seed=0):
    p = jl.init(jax.random.PRNGKey(seed), JI.FeedForwardType(n_in), dtype=jnp.float64)
    return p, {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in p.items()}


def _x(rs, n=4, n_in=5):
    return np.clip(rs.rand(n, n_in), 0.05, 0.95)


# ---------------------------------------------------------------------------
# the VAE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["gaussian", "bernoulli", "exponential", "composite",
                                  "loss_wrapper"])
def test_vae_config_round_trips_both_ways(dist):
    jl, tl = _vae(JL, dist, num_samples=2), _vae(TL, dist, num_samples=2)
    assert tserde.to_json(tl) == jserde.to_json(jl)
    back = tserde.from_json(jserde.to_json(jl))
    assert back == tl or tvae.resolve_distribution(back.reconstruction) == tl.dist


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli", "exponential", "composite",
                                  "loss_wrapper"])
def test_vae_elbo_and_gradients_match_jax_with_injected_draws(dist):
    jl, tl = _vae(JL, dist, num_samples=2), _vae(TL, dist, num_samples=2)
    rs = np.random.RandomState(0)
    x = _x(rs)
    p, tp = _params(jl, 5)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in tl.init(torch.Generator().manual_seed(0),
                                                 TI.FeedForwardType(5), torch.float64).items()}
    key = jax.random.PRNGKey(3)
    want, jg = jax.value_and_grad(lambda q: jl.pretrain_loss(q, jnp.asarray(x), key))(p)
    got = tl.pretrain_loss(tp, torch.from_numpy(x), eps=_jax_eps(key, (4, 2), 2))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    keys = sorted(tp)
    for k, g in zip(keys, torch.autograd.grad(got, [tp[k] for k in keys])):
        np.testing.assert_allclose(_np(g), np.asarray(jg[k]), err_msg=k, **TOL)
    # without draws z is the posterior mean in both
    np.testing.assert_allclose(tl.pretrain_loss(tp, torch.from_numpy(x)).item(),
                               float(jl.pretrain_loss(p, jnp.asarray(x), None)), **TOL)


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli", "exponential", "composite"])
def test_vae_encode_decode_generate_match_jax(dist):
    jl, tl = _vae(JL, dist), _vae(TL, dist)
    rs = np.random.RandomState(1)
    x = _x(rs)
    z = rs.randn(3, 2)
    p, tp = _params(jl, 5, seed=1)
    tx = torch.from_numpy(x)
    for got, want in ((tl.encode(tp, tx)[0], jl.encode(p, jnp.asarray(x))[0]),
                      (tl.encode(tp, tx)[1], jl.encode(p, jnp.asarray(x))[1]),
                      (tl.decode(tp, torch.from_numpy(z)), jl.decode(p, jnp.asarray(z))),
                      (tl.reconstruct(tp, tx), jl.reconstruct(p, jnp.asarray(x))),
                      (tl.generate_at_mean(tp, torch.from_numpy(z)),
                       jl.generate_at_mean(p, jnp.asarray(z))),
                      (tl.apply(tp, {}, tx)[0], jl.apply(p, {}, jnp.asarray(x))[0])):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    key = jax.random.PRNGKey(5)
    (eps,) = _jax_eps(key, (4, 2), 1)
    _, sub = jax.random.split(key)
    jz = jax.random.normal(sub, (4, 2), jnp.float64)
    mean, logvar = jl.encode(p, jnp.asarray(x))
    want = jl.generate_at_mean(p, mean + jnp.exp(0.5 * logvar) * jz)
    np.testing.assert_allclose(_np(tl.reconstruct(tp, tx, eps=eps)), np.asarray(want), **TOL)
    sample = tl.generate_random(tp, torch.from_numpy(z), torch.Generator().manual_seed(0))
    assert sample.shape == (3, 5) and torch.isfinite(sample).all()


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_reconstruction_probability_matches_jax(dist):
    jl, tl = _vae(JL, dist), _vae(TL, dist)
    x = _x(np.random.RandomState(2), n=6)
    p, tp = _params(jl, 5, seed=2)
    key = jax.random.PRNGKey(4)
    want = jl.reconstruction_probability(p, jnp.asarray(x), key, num_samples=3)
    got = tl.reconstruction_probability(tp, torch.from_numpy(x), num_samples=3,
                                        eps=_jax_eps(key, (6, 2), 3))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    own = tl.reconstruction_probability(tp, torch.from_numpy(x),
                                        torch.Generator().manual_seed(1), num_samples=3)
    assert own.shape == (6,) and torch.isfinite(own).all()


def test_bernoulli_clip_gradient_matches_jax_where_it_bites():
    """Saturated logits: the clip at 1e-7 zeroes the gradient, as in JAX
    (``binary_cross_entropy_with_logits`` would not)."""
    jd, td = JL.BernoulliReconstruction(), tvae.BernoulliReconstruction()
    pre = np.array([[40.0, -40.0, 0.3, -25.0]])
    x = np.array([[0.0, 1.0, 0.5, 0.2]])
    want, jg = jax.value_and_grad(lambda q: jnp.sum(jd.log_prob(q, jnp.asarray(x))))(
        jnp.asarray(pre))
    tpre = torch.from_numpy(pre).requires_grad_(True)
    got = td.log_prob(tpre, torch.from_numpy(x)).sum()
    (tg,) = torch.autograd.grad(got, [tpre])
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), **TOL)
    assert _np(tg)[0, 0] == 0.0 and _np(tg)[0, 1] == 0.0


def test_vae_example_width_has_the_jax_parameter_count():
    """dl4j-examples' VariationalAutoEncoderExample widths: 784 -> (256,
    256) -> 2 -> (256, 256) -> 784, Bernoulli."""
    def conf(L, I, Conf):
        return Conf(seed=1).list(
            L.VariationalAutoencoder(n_latent=2, encoder_layer_sizes=(256, 256),
                                     decoder_layer_sizes=(256, 256),
                                     reconstruction="bernoulli", activation="leakyrelu"),
            input_type=I.FeedForwardType(784))
    from deeplearning4j_tpu.nn.conf.memory import memory_report as jm

    assert memory_report(conf(TL, TI, TConf)).total_param_count == 535_828
    assert jm(conf(JL, JI, JConf)).total_param_count == 535_828


def test_vae_inside_a_network_matches_jax():
    def layers(L):
        return [L.VariationalAutoencoder(n_latent=3, encoder_layer_sizes=(6,),
                                         decoder_layer_sizes=(6,)),
                L.OutputLayer(n_out=2)]
    jconf = JConf(seed=2, updater=JU.Sgd(0.1)).list(*layers(JL), input_type=JI.FeedForwardType(5))
    jnet = JNet(jconf)
    jnet.init(dtype=jnp.float64)
    tnet = TNet(TMLC.from_json(jconf.to_json()), device="cpu")
    tnet.init(dtype=torch.float64)
    params_from_numpy(tnet, jax.tree_util.tree_map(np.asarray, jnet.params))
    x = np.random.RandomState(3).rand(4, 5)
    np.testing.assert_allclose(_np(tnet.output(x)), np.asarray(jnet.output(x)), **TOL)


def test_port_gradcheck_passes_on_a_narrow_vae():
    tl = _vae(TL, "gaussian")
    x = torch.from_numpy(_x(np.random.RandomState(4), n=3))
    params = tl.init(torch.Generator().manual_seed(0), TI.FeedForwardType(5), torch.float64)
    ok, failures = check_gradients(lambda p: tl.pretrain_loss(p, x), params,
                                   max_params_per_leaf=6)
    assert ok, failures[:3]


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def _quadratic(rs, n=6):
    m = rs.rand(n, n)
    a = m @ m.T + n * np.eye(n)
    b = rs.rand(n)
    return (lambda x: 0.5 * x @ jnp.asarray(a) @ x - jnp.asarray(b) @ x,
            lambda x: 0.5 * x @ torch.from_numpy(a) @ x - torch.from_numpy(b) @ x)


def _rosenbrock():
    return (lambda x: jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2),
            lambda x: torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2))


def _search_case(name):
    rs = np.random.RandomState(5)
    if name == "quadratic":
        jf, tf = _quadratic(rs)
        x = rs.randn(6)
        return jf, tf, x, None, {}
    if name == "rosenbrock_cubic":   # the first trial fails: interpolation
        jf, tf = _rosenbrock()
        return jf, tf, np.array([-1.2, 1.0, 0.5, -0.3]), None, {}
    if name == "step_max":            # the direction is scaled to step_max
        jf, tf = _quadratic(rs)
        x = 50.0 * rs.randn(6)
        return jf, tf, x, None, {"step_max": 3.0}
    if name == "no_accept":           # out of trials: the best step seen
        jf, tf = _rosenbrock()
        return jf, tf, np.array([-1.2, 1.0, 0.5, -0.3]), None, {"max_iterations": 1}
    if name == "ascent":              # an uphill direction: a zero step
        jf, tf = _quadratic(rs)
        x = rs.randn(6)
        g = np.asarray(jax.grad(jf)(jnp.asarray(x)))
        return jf, tf, x, g, {}
    raise KeyError(name)


@pytest.mark.parametrize("name", ["quadratic", "rosenbrock_cubic", "step_max", "no_accept",
                                  "ascent"])
def test_backtrack_line_search_matches_jax(name):
    jf, tf, x, direction, kw = _search_case(name)
    f0, g = jax.value_and_grad(jf)(jnp.asarray(x))
    d = -np.asarray(g) if direction is None else direction
    j_step, j_f = js.backtrack_line_search(jf, jnp.asarray(x), f0, g, jnp.asarray(d), **kw)
    t_step, t_f = ts.backtrack_line_search(tf, torch.from_numpy(x), torch.tensor(float(f0),
                                           dtype=torch.float64), torch.from_numpy(np.asarray(g)),
                                           torch.from_numpy(d), **kw)
    np.testing.assert_allclose(t_step.item(), float(j_step), **TOL)
    np.testing.assert_allclose(t_f.item(), float(j_f), **TOL)
    if name == "ascent":
        assert t_step.item() == 0.0


@pytest.mark.parametrize("algo", ["line_gradient_descent", "conjugate_gradient", "lbfgs"])
@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock"])
def test_first_three_iterations_match_jax(algo, problem):
    rs = np.random.RandomState(6)
    if problem == "quadratic":
        jf, tf = _quadratic(rs)
        x0 = rs.randn(6)
    else:
        jf, tf = _rosenbrock()
        x0 = np.array([-1.2, 1.0, 0.5, -0.3])
    for n in (1, 2, 3):
        kw = dict(max_iterations=n, tolerance=0.0)
        jx, jscore, jit = js.ALGORITHMS[algo](jf, **kw).optimize(jnp.asarray(x0))
        opt = ts.ALGORITHMS[algo](tf, **kw)
        tx, tscore, tit = opt.optimize(torch.from_numpy(x0))
        assert tit == jit == n
        np.testing.assert_allclose(_np(tx), np.asarray(jx), err_msg=f"iteration {n}", **TOL)
        np.testing.assert_allclose(tscore, jscore, **TOL)


def test_lbfgs_ring_wraps_like_jax():
    """More iterations than the memory (m=2): the ring overwrites its
    oldest pair as JAX's does."""
    jf, tf = _rosenbrock()
    x0 = np.array([-1.2, 1.0, 0.5, -0.3])
    jx, _, _ = js.LBFGS(jf, m=2, max_iterations=6, tolerance=0.0).optimize(jnp.asarray(x0))
    tx, _, _ = ts.LBFGS(tf, m=2, max_iterations=6, tolerance=0.0).optimize(torch.from_numpy(x0))
    np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=1e-8)


@pytest.mark.parametrize("fn", ["default", "negative_default", "gradient", "negative_gradient"])
def test_step_functions_match_jax(fn):
    x, d = np.array([1.0, -2.0]), np.array([0.5, 0.25])
    np.testing.assert_array_equal(
        ts.STEP_FUNCTIONS[fn](torch.from_numpy(x), torch.from_numpy(d), 0.3).numpy(),
        np.asarray(js.STEP_FUNCTIONS[fn](jnp.asarray(x), jnp.asarray(d), 0.3)))
    jf, tf = _quadratic(np.random.RandomState(7))
    x0 = np.random.RandomState(8).randn(6)
    if fn == "negative_default":  # the descent default: both packages converge alike
        jx, _, _ = js.LBFGS(jf, max_iterations=2, tolerance=0.0,
                            step_function=fn).optimize(jnp.asarray(x0))
        tx, _, _ = ts.LBFGS(tf, max_iterations=2, tolerance=0.0,
                            step_function=fn).optimize(torch.from_numpy(x0))
        np.testing.assert_allclose(_np(tx), np.asarray(jx), **TOL)
    with pytest.raises(ValueError, match="Unknown step_function"):
        ts.LBFGS(tf, step_function="sideways")


def _net_pair(seed=3):
    def layers(L):
        return [L.DenseLayer(n_out=6, activation="tanh"), L.BatchNormalization(),
                L.OutputLayer(n_out=3)]
    jconf = JConf(seed=seed, updater=JU.Sgd(0.1)).list(*layers(JL),
                                                       input_type=JI.FeedForwardType(4))
    jnet = JNet(jconf)
    jnet.init(dtype=jnp.float64)
    tnet = TNet(TMLC.from_json(jconf.to_json()), device="cpu")
    tnet.init(dtype=torch.float64)
    params_from_numpy(tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
                      state=jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient", "line_gradient_descent"])
def test_solver_trains_a_tiny_network_as_jax(algo):
    jnet, tnet = _net_pair()
    rs = np.random.RandomState(9)
    x = rs.randn(16, 4)
    y = np.eye(3)[rs.randint(0, 3, 16)]
    before = tnet.score(x, y)
    j_score = js.Solver(jnet, algo, max_iterations=3, tolerance=0.0).optimize(
        jnp.asarray(x), jnp.asarray(y))
    solver = ts.Solver(tnet, algo, max_iterations=3, tolerance=0.0)
    t_score = solver.optimize(x, y)
    np.testing.assert_allclose(t_score, j_score, **TOL)
    for jp, tp in zip(jnet.params, tnet.params):
        for k in jp:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), err_msg=k, rtol=1e-8,
                                       atol=1e-12)
    assert t_score < before and tnet.iteration == jnet.iteration == 3
    with pytest.raises(ValueError, match="SGD is the network's train step"):
        ts.Solver(tnet, "stochastic_gradient_descent")


class _HostReads(TorchDispatchMode):
    """Counts the ops that read a device value back to the host."""

    names = {"_local_scalar_dense", "nonzero", "masked_select", "item"}

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.names:
            self.count += 1
        return func(*args, **(kwargs or {}))


def test_an_iteration_reads_the_host_once():
    """The line search and the direction run on the device: the only host
    read an iteration is the score the loop compares with the tolerance."""
    jf, tf = _rosenbrock()
    x0 = torch.tensor([-1.2, 1.0, 0.5, -0.3], dtype=torch.float64)
    for algo in ts.ALGORITHMS:
        opt = ts.ALGORITHMS[algo](tf, max_iterations=4, tolerance=0.0)
        f, g = opt.value_and_grad(x0)
        aux = opt._init_aux(x0)
        with _HostReads() as reads:
            x1, _, aux, _ = opt.iteration(x0, g, f, aux)
            _, g1 = opt.value_and_grad(x1)
            opt._post_step(x1, x0, g1, g, aux)
        assert reads.count == 0, algo
        with _HostReads() as reads:
            opt.optimize(x0)
        assert reads.count == 5, algo  # the first score, then one an iteration
