"""The port's YOLOv2 output layer and TinyYOLO against the JAX package, on
the CPU.

The loss and its gradient with respect to the predictions in float64 at
rtol 1e-9 (+1e-12 of the largest |gradient|: the same sums in another
order), over labels that hold a box equal to an anchor, a box whose prior
IoU ties two anchors (the first argmax is responsible in both packages),
an empty image and an image with every cell full. ``get_predicted_objects``
gives the same detections in the same order, each float within 1e-12;
``non_max_suppression`` on them the same list. TinyYOLO's configuration is
the JAX package's and its parameter count the JAX builder's, 15,861,773.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import misc as JM
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.layers import objdetect as JO
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serde as jserde
from deeplearning4j_tpu_torch.models import get_model
from deeplearning4j_tpu_torch.models import misc as TM
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig as TConf
from deeplearning4j_tpu_torch.nn.layers import objdetect as TO
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.utils import serde as tserde
from deeplearning4j_tpu_torch.utils import serialization as tser

RTOL, ATOL_REL = 1e-9, 1e-12
ANCHORS = ((1.0, 1.0), (2.0, 2.0), (3.0, 1.5))
B, H, W, C = 4, 3, 4, 3


def _labels(rs):
    """[B, H, W, 5 + C]: image 0 a few boxes (one equal to anchor 2, one
    tying anchors 0 and 1: a 2 x 1 box, IoU 1/2 with both), image 1 empty, image 2 every
    cell full, image 3 random boxes."""
    y = np.zeros((B, H, W, 5 + C))

    def put(b, i, j, w, h, cls):
        y[b, i, j, 0] = 1.0
        y[b, i, j, 1:3] = rs.rand(2)
        y[b, i, j, 3:5] = (w, h)
        y[b, i, j, 5 + cls] = 1.0

    put(0, 0, 1, 3.0, 1.5, 2)
    put(0, 2, 3, 2.0, 1.0, 0)
    put(0, 1, 0, 0.7, 2.5, 1)
    for i in range(H):
        for j in range(W):
            put(2, i, j, *(0.2 + 3 * rs.rand(2)), rs.randint(C))
    for _ in range(3):
        put(3, rs.randint(H), rs.randint(W), *(0.2 + 3 * rs.rand(2)), rs.randint(C))
    return y


def _layers():
    j = JL.Yolo2OutputLayer(anchors=ANCHORS, lambda_coord=4.0, lambda_noobj=0.25)
    t = tserde.from_json(jserde.to_json(j))
    assert isinstance(t, TO.Yolo2OutputLayer) and tserde.to_json(t) == jserde.to_json(j)
    return j, t


def test_loss_and_gradient_match_jax_in_float64():
    rs = np.random.RandomState(0)
    jl, tl = _layers()
    x = 2.0 * rs.randn(B, H, W, len(ANCHORS) * (5 + C))
    x[..., 2:4] = 9.0 * np.sign(x[..., 2:4])  # some beyond the exp clip
    y = _labels(rs)
    loss_j, grad_j = jax.value_and_grad(lambda p: jl.compute_loss(p, jnp.asarray(y)))(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    loss_t = tl.compute_loss(tx, torch.from_numpy(y))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=RTOL)
    g = np.asarray(grad_j)
    np.testing.assert_allclose(tx.grad.numpy(), g, rtol=RTOL, atol=ATOL_REL * np.abs(g).max())


def test_tied_prior_iou_takes_the_first_anchor():
    _, tl = _layers()
    gt = torch.tensor([[2.0, 1.0]], dtype=torch.float64)
    anchors = torch.tensor(ANCHORS, dtype=torch.float64)
    iou = TO._iou_wh(anchors[:, 0], anchors[:, 1], gt[..., None, 0], gt[..., None, 1])
    assert iou[0, 0] == iou[0, 1] and int(iou.argmax(-1)) == 0


def test_predicted_objects_and_nms_match_jax():
    rs = np.random.RandomState(1)
    jl, tl = _layers()
    x = 1.5 * rs.randn(B, H, W, len(ANCHORS) * (5 + C))
    dj = jl.get_predicted_objects(jnp.asarray(x), threshold=0.6)
    dt = tl.get_predicted_objects(torch.from_numpy(x), threshold=0.6)
    assert [len(d) for d in dt] == [len(d) for d in dj] and sum(map(len, dt)) > 5
    for img_t, img_j in zip(dt, dj):
        for a, b in zip(img_t, img_j):
            assert a[5] == b[5]
            np.testing.assert_allclose(a[:5], b[:5], rtol=0, atol=1e-12)
    for img_t in dt:
        assert TO.non_max_suppression(img_t, 0.3) == JO.non_max_suppression(img_t, 0.3)
        assert [TO.box_iou(a[1:5], b[1:5]) for a in img_t for b in img_t] == \
            [JO.box_iou(a[1:5], b[1:5]) for a in img_t for b in img_t]


def _small_yolo(C_, L, I):
    return C_(seed=2).list(
        L.ConvolutionLayer(n_out=8, kernel=(3, 3), stride=(2, 2), padding="same",
                           activation="leakyrelu"),
        L.ConvolutionLayer(n_out=len(ANCHORS) * (5 + C), kernel=(1, 1), padding="same"),
        L.Yolo2OutputLayer(anchors=ANCHORS), input_type=I.ConvolutionalType(2 * H, 2 * W, 3))


def test_network_step_through_the_yolo_head_matches_jax_in_float64():
    jnet = JNet(_small_yolo(JConf, JL, JI))
    jnet.init()
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jnet.params)
    tnet = TNet(_small_yolo(TConf, TL, TI), device="cpu")
    tnet.init(dtype=torch.float64)
    tser.params_from_numpy(tnet, jax.tree_util.tree_map(np.asarray, p64))
    rs = np.random.RandomState(3)
    x, y = rs.rand(B, 2 * H, 2 * W, 3), _labels(rs)
    loss_j, _, grads_j = jax.jit(jnet.compute_gradients)(p64, jnet.state, jnp.asarray(x),
                                                         jnp.asarray(y))
    loss_t, _, grads_t = tnet.compute_gradients(tnet.params, tnet.state, torch.from_numpy(x),
                                                torch.from_numpy(y))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL)
    for gt, gj in zip(grads_t, grads_j):
        for k in gj:
            g = np.asarray(gj[k])
            np.testing.assert_allclose(gt[k].numpy(), g, rtol=RTOL,
                                       atol=ATOL_REL * np.abs(g).max(), err_msg=k)


def test_tiny_yolo_is_the_jax_registry_entry_at_full_width():
    jconf, tconf = JM.tiny_yolo(), TM.tiny_yolo()
    assert tconf.to_json() == jconf.to_json()
    assert get_model("tinyyolo").builder is TM.tiny_yolo
    net = TNet(tconf, device="cpu")
    net.init()
    assert net.num_params() == 15_861_773
    out_type = tconf.layer_input_types()[1]
    assert (out_type.height, out_type.width, out_type.channels) == (13, 13, 125)


@pytest.mark.parametrize("n_classes", [1, 4])
def test_tiny_yolo_forward_at_a_small_size(n_classes):
    net = get_model("tinyyolo").build(device="cpu", height=64, width=64, n_classes=n_classes)
    out = net.output(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    assert tuple(out.shape) == (2, 2, 2, 5 * (5 + n_classes))
    dets = net.conf.layers[-1].get_predicted_objects(out, threshold=0.0)
    assert len(dets) == 2 and len(dets[0]) == 2 * 2 * 5
