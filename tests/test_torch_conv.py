"""The port's conv slice against the JAX package, on the CPU.

The conv-statistics kernels' plain versions against the Pallas kernels in
interpret mode; ``fused_conv_bn_act`` forward and backward against the JAX
custom VJP; the conv layers; ``FusedConvBNVertex`` in train mode (the JAX
vertex through its interpret seam) and eval mode; LeNet from one zip.

Tolerances: f32 conv outputs atol 1e-5 (the reference's f32 kernel
tolerance; sums of <= 2304 products in another order) and statistics rtol
1e-5 + atol 1e-4 (sums over all rows of z and z^2); bf16 z within one bf16
ulp (2e-2 + 2e-2·|x|: the f32 accumulators may straddle a rounding
boundary) and its statistics rtol 1e-4 (from the f32 accumulators, which
agree to f32 noise). The fused op's forward atol 1e-5 and gradients 2e-4,
as tests/test_fused_conv.py pins the reference against its XLA
composition; layer gradients 2e-5 + rtol 2e-4 (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.lenet import lenet as j_lenet
from deeplearning4j_tpu.nn import fusion as JF
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops import conv_pallas as cp
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.models import lenet as t_lenet
from deeplearning4j_tpu_torch.nn import fusion as TF
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.ops import conv_stats as C
from deeplearning4j_tpu_torch.utils import serialization as tser

# the geometries of tests/test_fused_conv.py: (kernel, stride, cin, cout)
GEOMETRIES = [((1, 1), (1, 1), 64, 256), ((1, 1), (2, 2), 256, 512), ((3, 3), (1, 1), 64, 64),
              ((3, 3), (2, 2), 32, 64), ((1, 1), (1, 1), 48, 96)]
GEOM_IDS = ["1x1", "1x1s2", "3x3", "3x3s2", "1x1_48to96"]


def _np(a):
    return np.asarray(a.detach().float().numpy() if torch.is_tensor(a) else
                      np.asarray(a, np.float32))


def _inputs(kern, stride, cin, cout, hw=8, batch=4, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, hw, hw, cin).astype(np.float32)
    w = (0.1 * rs.randn(*kern, cin, cout)).astype(np.float32)
    gamma = (rs.rand(cout) + 0.5).astype(np.float32)
    beta = rs.randn(cout).astype(np.float32)
    ho = -(-hw // stride[0])
    r = rs.randn(batch, ho, ho, cout).astype(np.float32)
    return x, w, gamma, beta, r


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kern,stride,cin,cout", GEOMETRIES, ids=GEOM_IDS)
def test_plain_versions_match_pallas_kernels(kern, stride, cin, cout, dtype):
    x, w, *_ = _inputs(kern, stride, cin, cout)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    if kern == (1, 1):
        xs = xj[:, ::stride[0], ::stride[1], :]
        z2d, st_j = cp._matmul_stats(xs.reshape(-1, cin), wj.reshape(cin, cout), True)
        z_j = z2d.reshape(*xs.shape[:3], cout)
        z_t, st_t = C.conv_mm_stats_plain(torch.from_numpy(x).to(tdt),
                                          torch.from_numpy(w).to(tdt).reshape(cin, cout), stride)
    else:
        z_j, st_j = cp._conv3x3_stats(xj, wj, True, stride=stride[0])
        z_t, st_t = C.conv3x3_stats_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                                          stride)
    assert z_t.dtype == tdt and st_t.dtype == torch.float32
    assert tuple(z_t.shape) == tuple(z_j.shape) and tuple(st_t.shape) == (2, cout)
    zj = np.asarray(z_j.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(_np(z_t), zj, atol=1e-5)
        np.testing.assert_allclose(_np(st_t), np.asarray(st_j), rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_allclose(_np(z_t), zj, atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(_np(st_t), np.asarray(st_j), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kern,stride,cin,cout", GEOMETRIES, ids=GEOM_IDS)
def test_kernel_wrappers_take_the_plain_version_on_cpu_tensors(kern, stride, cin, cout):
    x, w, *_ = _inputs(kern, stride, cin, cout, seed=1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = dict(C.launches)
    got = C.conv_z(xt, wt, stride)
    want = (C.conv_mm_stats_plain(xt, wt.reshape(cin, cout), stride) if kern == (1, 1)
            else C.conv3x3_stats_plain(xt, wt, stride))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert C.launches == before  # the plain version launches nothing


def test_kernel_wrappers_refuse_other_devices():
    x = torch.empty(2, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        C.conv_mm_stats(x, torch.empty(8, 16, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        C.conv3x3_stats(x, torch.empty(3, 3, 8, 16, device="meta"))


def test_supported_matrix_matches_jax():
    cases = [((1, 1), (2, 2), "same", (1, 1), "relu", None),
             ((3, 3), (1, 1), "same", (1, 1), "identity", None),
             ((3, 3), (2, 2), "same", (1, 1), "relu", (4, 8, 8, 32)),
             ((3, 3), (2, 2), "same", (1, 1), "relu", (4, 7, 7, 32)),
             ((3, 3), (2, 2), "same", (1, 1), "relu", None),
             ((7, 7), (2, 2), "same", (1, 1), "relu", None),
             ((3, 3), (1, 1), "valid", (1, 1), "relu", None),
             ((3, 3), (1, 1), "same", (2, 2), "relu", None),
             ((1, 1), (1, 1), "same", (1, 1), "tanh", None)]
    for *args, shape in cases:
        assert C.supported(*args, x_shape=shape) == cp.supported(*args, x_shape=shape), args


def test_same_pads_are_xla_pads():
    assert C.same_pads(224, 7, 2) == (2, 3)   # the stem conv
    assert C.same_pads(112, 3, 2) == (0, 1)   # the stem pool
    assert C.same_pads(56, 3, 1) == (1, 1)
    assert C.same_pads(8, 3, 2) == (0, 1)
    assert C.same_pads(7, 3, 2) == (1, 1)


# ---------------------------------------------------------------------------
# the fused op against the JAX custom VJP
# ---------------------------------------------------------------------------

FUSED_CASES = [((1, 1), (1, 1), "relu", True), ((1, 1), (2, 2), "relu", True),
               ((3, 3), (1, 1), "relu", True), ((3, 3), (2, 2), "relu", True),
               ((1, 1), (2, 2), "identity", False), ((3, 3), (1, 1), "identity", False)]


@pytest.mark.parametrize("kern,stride,act,residual", FUSED_CASES,
                         ids=["1x1", "1x1s2", "3x3", "3x3s2", "proj", "3x3_id"])
def test_fused_op_forward_and_backward_match_jax_vjp(kern, stride, act, residual):
    x, w, gamma, beta, r = _inputs(kern, stride, 32, 64, hw=4, batch=2, seed=3)
    dy = np.random.RandomState(4).randn(*r.shape).astype(np.float32)

    def jf(x_, w_, g_, b_, r_):
        return cp.fused_conv_bn_act(x_, w_, g_, b_, r_ if residual else None, stride, 1e-5, act,
                                    True)
    (y_j, m_j, v_j), vjp = jax.vjp(jf, *map(jnp.asarray, (x, w, gamma, beta, r)))
    grads_j = vjp((jnp.asarray(dy), jnp.zeros_like(m_j), jnp.zeros_like(v_j)))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, gamma, beta, r)]
    y_t, m_t, v_t = C.fused_conv_bn_act(*ts[:4], ts[4] if residual else None, stride, 1e-5, act)
    assert not m_t.requires_grad and not v_t.requires_grad
    y_t.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(_np(m_t), np.asarray(m_j), atol=1e-6)
    np.testing.assert_allclose(_np(v_t), np.asarray(v_j), atol=1e-5)
    names = ["x", "w", "gamma", "beta", "residual"]
    for name, t, g in zip(names, ts, grads_j):
        if name == "residual" and not residual:
            assert t.grad is None
            continue
        np.testing.assert_allclose(_np(t.grad), np.asarray(g), atol=2e-4, err_msg=name)


def test_fused_op_under_bf16_keeps_f32_statistics():
    x, w, gamma, beta, r = _inputs((1, 1), (1, 1), 64, 64, seed=5)
    xb, wb, rb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, r))
    y, m, v = C.fused_conv_bn_act(xb, wb, torch.from_numpy(gamma), torch.from_numpy(beta), rb)
    y_j, m_j, v_j = cp.fused_conv_bn_act(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w)),
                                         jnp.asarray(gamma), jnp.asarray(beta),
                                         jnp.asarray(r).astype(jnp.bfloat16), (1, 1), 1e-5,
                                         "relu", True)
    assert y.dtype == torch.bfloat16 and m.dtype == v.dtype == torch.float32
    np.testing.assert_allclose(_np(m), np.asarray(m_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(v), np.asarray(v_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(y), np.asarray(y_j.astype(jnp.float32)), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_pair(jlayer, tlayer, in_type_j, in_type_t, x, seed=0, train=False, state=None):
    """Forward (and, for parameter layers, gradients of sum(y * g)) of the
    two packages' layers on the same numpy parameters and input."""
    params = {k: np.asarray(v) for k, v in jlayer.init(jax.random.PRNGKey(seed), in_type_j).items()}
    rs = np.random.RandomState(seed + 1)
    params = {k: (v + 0.1 * rs.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
    st = state if state is not None else {k: np.asarray(v) for k, v in
                                          jlayer.init_state(in_type_j).items()}
    y_j, s_j = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()},
                            {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(x),
                            train=train)
    g = rs.randn(*y_j.shape).astype(np.float32)
    grads_j = jax.grad(lambda p: jnp.sum(jlayer.apply(p, {k: jnp.asarray(v) for k, v in st.items()},
                                                      jnp.asarray(x), train=train)[0] * g))(
        {k: jnp.asarray(v) for k, v in params.items()}) if params else {}
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    y_t, s_t = tlayer.apply(tp, {k: torch.from_numpy(v) for k, v in st.items()},
                            torch.from_numpy(x), train=train)
    if tp:
        (y_t * torch.from_numpy(g)).sum().backward()
    return (y_t, s_t, {k: v.grad for k, v in tp.items()}), (y_j, s_j, grads_j)


CONV_CASES = [dict(n_out=6, kernel=(3, 3), stride=(1, 1), padding="valid"),
              dict(n_out=6, kernel=(3, 3), stride=(2, 2), padding="same"),
              dict(n_out=6, kernel=(7, 7), stride=(2, 2), padding="same", has_bias=False),
              dict(n_out=4, kernel=(2, 3), stride=(1, 2), padding="explicit", pad=(1, 2)),
              dict(n_out=4, kernel=(3, 3), padding="same", dilation=(2, 2), activation="relu")]


@pytest.mark.parametrize("kw", CONV_CASES, ids=["valid", "same_s2", "stem_7x7", "explicit",
                                                "dilated"])
def test_convolution_layer_matches_jax(kw):
    x = np.random.RandomState(0).randn(2, 10, 10, 3).astype(np.float32)
    jl, tl = JL.ConvolutionLayer(**kw), TL.ConvolutionLayer(**kw)
    assert tl.output_type(TI.ConvolutionalType(10, 10, 3)).shape(2) == \
        jl.output_type(JI.ConvolutionalType(10, 10, 3)).shape(2)
    (y_t, _, g_t), (y_j, _, g_j) = _layer_pair(jl, tl, JI.ConvolutionalType(10, 10, 3),
                                               TI.ConvolutionalType(10, 10, 3), x)
    assert tuple(y_t.shape) == tuple(y_j.shape)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=1e-5)
    for k in g_j:
        np.testing.assert_allclose(_np(g_t[k]), np.asarray(g_j[k]), atol=2e-5, rtol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("kw", [dict(kernel=(3, 3), stride=(2, 2), padding="same", mode="max"),
                                dict(kernel=(3, 3), stride=(2, 2), padding="same", mode="avg"),
                                dict(kernel=(2, 2), stride=(2, 2), mode="max"),
                                dict(kernel=(3, 3), stride=(1, 1), padding="same", mode="sum"),
                                dict(kernel=(2, 2), stride=(2, 2), mode="pnorm", pnorm=3),
                                dict(kernel=(3, 2), stride=(2, 1), padding="explicit",
                                     pad=(1, 1), mode="avg")],
                         ids=["max_same_s2", "avg_same_s2", "max_valid", "sum_same",
                              "pnorm", "avg_explicit"])
def test_subsampling_layer_matches_jax(kw):
    x = np.random.RandomState(1).randn(2, 8, 9, 3).astype(np.float32)
    (y_t, _, _), (y_j, _, _) = _layer_pair(JL.SubsamplingLayer(**kw), TL.SubsamplingLayer(**kw),
                                           JI.ConvolutionalType(8, 9, 3),
                                           TI.ConvolutionalType(8, 9, 3), x)
    assert tuple(y_t.shape) == tuple(y_j.shape)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=1e-5, rtol=1e-5)


def test_same_max_pool_pads_high_with_minus_inf():
    """All-negative input: a zero pad, or a pad at the low end, would show."""
    x = -1.0 - np.arange(2 * 4 * 4).reshape(1, 4, 4, 2).astype(np.float32)
    layer = TL.SubsamplingLayer(kernel=(3, 3), stride=(2, 2), padding="same", mode="max")
    y, _ = layer.apply({}, {}, torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy()[0, :, :, 0], [[-1.0, -5.0], [-17.0, -21.0]])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", [(4, 5, 5, 6), (8, 6)], ids=["cnn", "ff"])
def test_batch_normalization_matches_jax(shape, train):
    rs = np.random.RandomState(2)
    x = (2.0 + 3.0 * rs.randn(*shape)).astype(np.float32)
    it_j = JI.ConvolutionalType(*shape[1:]) if len(shape) == 4 else JI.FeedForwardType(shape[1])
    it_t = TI.ConvolutionalType(*shape[1:]) if len(shape) == 4 else TI.FeedForwardType(shape[1])
    state = {"mean": rs.randn(shape[-1]).astype(np.float32),
             "var": (rs.rand(shape[-1]) + 0.5).astype(np.float32)}
    jl, tl = JL.BatchNormalization(activation="relu"), TL.BatchNormalization(activation="relu")
    (y_t, s_t, g_t), (y_j, s_j, g_j) = _layer_pair(jl, tl, it_j, it_t, x, train=train,
                                                   state=state)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=1e-5)
    for k in ("mean", "var"):
        assert not s_t[k].requires_grad
        np.testing.assert_allclose(_np(s_t[k]), np.asarray(s_j[k]), rtol=1e-6, atol=1e-6)
    for k in g_j:
        np.testing.assert_allclose(_np(g_t[k]), np.asarray(g_j[k]), atol=2e-5, rtol=2e-4)
    if train:  # the biased batch variance, decay 0.9
        xf = x.reshape(-1, shape[-1])
        np.testing.assert_allclose(_np(s_t["var"]), 0.9 * state["var"] + 0.1 * xf.var(0),
                                   rtol=1e-5)


@pytest.mark.parametrize("mode", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_and_activation_layers_match_jax(mode):
    rs = np.random.RandomState(3)
    x4, x3 = rs.randn(2, 3, 4, 5).astype(np.float32), rs.randn(2, 6, 5).astype(np.float32)
    mask = (rs.rand(2, 6) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    jl, tl = JL.GlobalPoolingLayer(mode=mode), TL.GlobalPoolingLayer(mode=mode)
    for x, m in ((x4, None), (x3, None), (x3, mask)):
        kw_j = {} if m is None else {"mask": jnp.asarray(m)}
        kw_t = {} if m is None else {"mask": torch.from_numpy(m)}
        y_j, _ = jl.apply({}, {}, jnp.asarray(x), **kw_j)
        y_t, _ = tl.apply({}, {}, torch.from_numpy(x), **kw_t)
        np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    y_j, _ = JL.ActivationLayer(activation="relu").apply({}, {}, jnp.asarray(x4))
    y_t, _ = TL.ActivationLayer(activation="relu").apply({}, {}, torch.from_numpy(x4))
    np.testing.assert_array_equal(_np(y_t), np.asarray(y_j))


# ---------------------------------------------------------------------------
# the fused vertex
# ---------------------------------------------------------------------------

VERTEX_CASES = [dict(n_out=16, kernel=(3, 3), activation="relu", residual=True),
                dict(n_out=16, kernel=(1, 1), stride=(2, 2), activation="identity"),
                dict(n_out=8, kernel=(1, 1), activation="relu", residual=True)]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kw", VERTEX_CASES, ids=["3x3_res", "proj_s2", "1x1_res"])
def test_fused_vertex_matches_jax(kw, train, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FUSED_CONV_INTERPRET", "1")
    rs = np.random.RandomState(6)
    cin = 8
    jv, tv = JF.FusedConvBNVertex(**kw), TF.FusedConvBNVertex(**kw)
    it = [JI.ConvolutionalType(6, 6, cin)]
    params = {k: np.asarray(v) + 0.1 * rs.randn(*v.shape).astype(np.float32)
              for k, v in jv.init(jax.random.PRNGKey(0), it).items()}
    state = {"mean": 0.1 * rs.randn(kw["n_out"]).astype(np.float32),
             "var": (rs.rand(kw["n_out"]) + 0.5).astype(np.float32)}
    x = rs.randn(3, 6, 6, cin).astype(np.float32)
    ho = 3 if kw.get("stride") == (2, 2) else 6
    xs = [x] + ([rs.randn(3, ho, ho, kw["n_out"]).astype(np.float32)]
                if kw.get("residual") else [])
    assert tv.output_type([TI.ConvolutionalType(6, 6, cin)]).shape(3) == \
        jv.output_type(it).shape(3)
    y_j, s_j = jv.apply({k: jnp.asarray(v) for k, v in params.items()},
                        {k: jnp.asarray(v) for k, v in state.items()},
                        [jnp.asarray(a) for a in xs], train=train)
    y_t, s_t = tv.apply({k: torch.from_numpy(v) for k, v in params.items()},
                        {k: torch.from_numpy(v) for k, v in state.items()},
                        [torch.from_numpy(a) for a in xs], train=train)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(_np(s_t[k]), np.asarray(s_j[k]), rtol=1e-6, atol=1e-6)
    if not train:
        assert s_t["mean"] is not None and np.array_equal(_np(s_t["mean"]), state["mean"])


def test_fused_vertex_train_mode_uses_the_kernel_formula():
    """Train mode takes ``fused_conv_bn_act``: its variance is
    E[z^2] - mean^2 from the kernel's sums, not the two-pass variance."""
    v = TF.FusedConvBNVertex(n_out=4, kernel=(1, 1))
    calls = []
    real = C.conv_mm_stats

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    C.conv_mm_stats = spy
    try:
        p = {"W": torch.randn(1, 1, 3, 4), "gamma": torch.ones(4), "beta": torch.zeros(4)}
        s = {"mean": torch.zeros(4), "var": torch.ones(4)}
        v.apply(p, s, [torch.randn(2, 3, 3, 3)], train=True)
        assert calls == [1]
        v.apply(p, s, [torch.randn(2, 3, 3, 3)], train=False)
        assert calls == [1]
    finally:
        C.conv_mm_stats = real


# ---------------------------------------------------------------------------
# LeNet (a MultiLayerNetwork with ConvolutionLayer, max pooling, flatten)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lenet_zip(tmp_path_factory):
    net = JNet(j_lenet())
    net.init()
    path = tmp_path_factory.mktemp("lenet") / "lenet.zip"
    jser.save_model(net, str(path))
    return path


def test_lenet_forward_loss_and_gradients_match_jax(lenet_zip):
    assert t_lenet().to_json() == j_lenet().to_json()
    jnet = jser.load_model(str(lenet_zip))
    tnet = tser.load_model(lenet_zip, device="cpu")
    assert tnet.num_params() == jnet.num_params() == 431_080
    rs = np.random.RandomState(7)
    x = rs.rand(3, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 3)]
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x)), atol=1e-5)
    loss_j, _, g_j = jnet.compute_gradients(jnet.params, jnet.state, jnp.asarray(x),
                                            jnp.asarray(y))
    loss_t, _, g_t = tnet.compute_gradients(tnet.params, tnet.state, torch.from_numpy(x),
                                            torch.from_numpy(y))
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-5)
    for i, (gt, gj) in enumerate(zip(g_t, g_j)):
        assert set(gt) == set(gj)
        for k in gj:
            np.testing.assert_allclose(_np(gt[k]), np.asarray(gj[k]), atol=2e-5, rtol=2e-4,
                                       err_msg=f"layer {i} {k}")


def test_lenet_trains_on_the_cpu():
    net = TNet(t_lenet(), device="cpu")
    net.init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(8)
    x = rs.rand(8, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 8)]
    net.fit((x, y), batch_size=8, epochs=4)
    first = net.score(x, y)
    net.fit((x, y), batch_size=8, epochs=4)
    assert net.score(x, y) < first
