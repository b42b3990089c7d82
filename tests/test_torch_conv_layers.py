"""The port's other conv layers against the JAX package, on the CPU.

Each layer's config goes through JSON (written by the JAX package, read by
the port), then its forward, the gradient of sum(y * g) for a random g
with respect to its input and to each parameter, in float64 from the same
numpy inputs. Tolerance: rtol 1e-9 + atol 1e-12 x the largest |value| of
the reference tensor (the same sums in another order, in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.utils import serde as jserde
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.utils import serde as tserde

RTOL, ATOL_REL = 1e-9, 1e-12

CASES = (
    [(f"deconv_k{k}_s{s}_{pad}", JL.Deconvolution2DLayer(n_out=3, kernel=(k, k), stride=(s, s),
                                                          padding=pad, pad=(1, 1)),
      ("cnn", 5, 6, 4))
     for k in (2, 3, 4) for s in (1, 2) for pad in ("same", "valid", "explicit")]
    + [("deconv_rect", JL.Deconvolution2DLayer(n_out=2, kernel=(3, 2), stride=(2, 3),
                                               padding="explicit", pad=(2, 1),
                                               activation="tanh"), ("cnn", 4, 5, 3))]
    + [(f"sepconv_m{m}_{pad}", JL.SeparableConvolution2DLayer(
        n_out=5, kernel=(3, 3), stride=(s, s), padding=pad, pad=(1, 1), depth_multiplier=m,
        activation="relu"), ("cnn", 7, 6, 3))
       for m in (1, 2) for pad, s in (("same", 2), ("valid", 1), ("explicit", 1))]
    + [(f"conv1d_{pad}_s{s}_d{d}", JL.Convolution1DLayer(n_out=4, kernel=3, stride=s,
                                                         padding=pad, pad=1, dilation=d),
        ("rnn", 9, 3))
       for pad in ("same", "valid", "explicit") for s, d in ((1, 1), (2, 1), (1, 2))]
    + [(f"subsampling1d_{mode}_{pad}", JL.Subsampling1DLayer(kernel=3, stride=2, padding=pad,
                                                             mode=mode), ("rnn", 9, 4))
       for mode in ("max", "avg", "sum") for pad in ("same", "valid")]
    + [("upsampling2d", JL.Upsampling2DLayer(size=(2, 3)), ("cnn", 3, 5, 2)),
       ("upsampling1d", JL.Upsampling1DLayer(size=3), ("rnn", 5, 2)),
       ("zeropadding", JL.ZeroPaddingLayer(pad=(1, 2, 0, 3)), ("cnn", 3, 5, 2)),
       ("zeropadding1d", JL.ZeroPadding1DLayer(pad=(2, 1)), ("rnn", 5, 2)),
       ("space_to_depth", JL.SpaceToDepthLayer(blocks=2), ("cnn", 4, 6, 3)),
       ("space_to_batch", JL.SpaceToBatchLayer(blocks=(2, 3)), ("cnn", 4, 6, 3))]
)


def _types(spec):
    if spec[0] == "cnn":
        return JI.ConvolutionalType(*spec[1:]), TI.ConvolutionalType(*spec[1:]), (3,) + spec[1:]
    return JI.RecurrentType(spec[2], spec[1]), TI.RecurrentType(spec[2], spec[1]), \
        (3, spec[1], spec[2])


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * scale, err_msg=what)


@pytest.mark.parametrize("jlayer,spec", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_layer_matches_jax_in_float64(jlayer, spec):
    tlayer = tserde.from_json(jserde.to_json(jlayer))
    assert type(tlayer).__name__ == type(jlayer).__name__
    assert tserde.to_json(tlayer) == jserde.to_json(jlayer)
    j_in, t_in, shape = _types(spec)
    rs = np.random.RandomState(len(jserde.to_json(jlayer)))
    x = rs.randn(*shape)
    params = {k: np.asarray(v, np.float64) for k, v in
              jlayer.init(jax.random.PRNGKey(0), j_in, jnp.float64).items()}
    params = {k: rs.randn(*v.shape) * 0.5 for k, v in params.items()}

    y_j = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()}, {}, jnp.asarray(x))[0]
    # the port's output type is the JAX package's
    assert tlayer.output_type(t_in).shape(1) == jlayer.output_type(j_in).shape(1)
    g = rs.randn(*y_j.shape)

    def j_loss(p, xx):
        return jnp.sum(jlayer.apply(p, {}, xx)[0] * g)

    gp_j, gx_j = jax.grad(j_loss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in params.items()},
                                                   jnp.asarray(x))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    y_t = tlayer.apply(tp, {}, tx)[0]
    assert y_t.dtype == torch.float64
    _close(y_t.detach().numpy(), y_j, "forward")
    (y_t * torch.from_numpy(g)).sum().backward()
    _close(tx.grad.numpy(), gx_j, "input gradient")
    for k in params:
        _close(tp[k].grad.numpy(), gp_j[k], f"gradient of {k}")


PARAM_CASES = [c for c in CASES if c[0] in ("deconv_k3_s2_same", "sepconv_m2_same",
                                              "conv1d_same_s1_d1")]


@pytest.mark.parametrize("jlayer,spec", [c[1:] for c in PARAM_CASES],
                         ids=[c[0] for c in PARAM_CASES])
def test_layer_init_shapes_match_jax(jlayer, spec):
    j_in, t_in, _ = _types(spec)
    tlayer = tserde.from_json(jserde.to_json(jlayer))
    jp = jlayer.init(jax.random.PRNGKey(0), j_in)
    tp = tlayer.init(torch.Generator().manual_seed(0), t_in)
    assert {k: tuple(v.shape) for k, v in jp.items()} == {k: tuple(v.shape) for k, v in tp.items()}


def test_space_to_depth_orders_channels_block_first():
    """(bh, bw, c), not ``pixel_unshuffle``'s (c, bh, bw)."""
    tlayer = tserde.from_json(jserde.to_json(JL.SpaceToDepthLayer(blocks=2)))
    x = torch.arange(2 * 2 * 3, dtype=torch.float64).reshape(1, 2, 2, 3)
    y = tlayer.apply({}, {}, x)[0]
    assert y[0, 0, 0].tolist() == x[0].reshape(-1).tolist()
    unshuffled = torch.nn.functional.pixel_unshuffle(x.permute(0, 3, 1, 2), 2)
    assert not torch.equal(unshuffled[0, :, 0, 0], y[0, 0, 0])
