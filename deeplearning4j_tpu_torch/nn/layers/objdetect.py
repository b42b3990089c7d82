"""YOLOv2 object-detection output layer (reference: nn/conf/layers/
objdetect/Yolo2OutputLayer.java, nn/layers/objdetect/Yolo2OutputLayer.java,
DetectedObject.java).

The port of ``deeplearning4j_tpu/nn/layers/objdetect.py``, the same loss to
the rounding. The input is the logical NHWC conv activation
``[B, H, W, A*(5+C)]`` (A anchors; tx ty tw th confidence, then C class
scores), reshaped to ``[B, H, W, A, 5+C]``: the port's activations are
logically NHWC whatever their memory layout, so the reshape is of the
logical tensor. Labels are ``[B, H, W, 5+C]`` per grid cell: an indicator
(1 marks the cell holding an object's centre), the centre's offset in the
cell, its width and height in grid units, and a one-hot class. The loss
(Redmon et al., YOLOv2, as the reference) is

  lambda_coord * (position MSE + MSE of sqrt(w), sqrt(h))
+ confidence MSE toward the IoU on the responsible anchor
+ lambda_noobj * confidence^2 everywhere else
+ class cross-entropy on the responsible anchor,

summed and divided by the batch. The responsible anchor of an object cell
is the first argmax of the IoU between the anchor priors and the box
(``torch.argmax`` returns the first maximum, as ``jnp.argmax``); ``exp``
is clipped at +-8 and the IoU's union and the class probabilities at
1e-9, as in the JAX package. ``get_predicted_objects`` and
``non_max_suppression`` run on the host and return the JAX package's
lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.utils.serde import register_config


def _iou_wh(w1, h1, w2, h2):
    """IoU of boxes sharing a centre."""
    inter = torch.minimum(w1, w2) * torch.minimum(h1, h2)
    union = w1 * h1 + w2 * h2 - inter
    return inter / union.clamp_min(1e-9)


@register_config
@dataclasses.dataclass(frozen=True)
class Yolo2OutputLayer(Layer):
    anchors: tuple = ((1.0, 1.0), (2.0, 2.0))  # (w, h) in grid units
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5

    input_family = _inputs.ConvolutionalType

    @property
    def n_anchors(self):
        return len(self.anchors)

    def output_type(self, input_type):
        return input_type

    def apply(self, params, state, x, *, train=False):
        return x, state

    def _decode(self, x):
        """Raw conv output -> per-anchor (xy in [0, 1], wh in grid units,
        confidence, class probabilities)."""
        b, h, w, _ = x.shape
        x = x.reshape(b, h, w, self.n_anchors, -1)
        txy = torch.sigmoid(x[..., 0:2])
        anchors = torch.tensor(self.anchors, dtype=x.dtype, device=x.device)  # [A, 2]
        twh = torch.exp(x[..., 2:4].clamp(-8, 8)) * anchors
        conf = torch.sigmoid(x[..., 4])
        cls = torch.softmax(x[..., 5:], dim=-1)
        return txy, twh, conf, cls

    def compute_loss(self, predictions, labels, mask=None):
        txy, twh, conf, cls = self._decode(predictions)
        b = txy.shape[0]
        a = self.n_anchors
        labels = labels.to(predictions.dtype)
        indicator = labels[..., 0]                     # [B,H,W]
        gt_xy = labels[..., 1:3]                       # offsets within the cell
        gt_wh = labels[..., 3:5]                       # grid units
        gt_cls = labels[..., 5:]

        # responsible anchor: the best IoU(anchor prior, box) per object cell
        anchors = torch.tensor(self.anchors, dtype=predictions.dtype, device=predictions.device)
        prior_iou = _iou_wh(anchors[:, 0], anchors[:, 1], gt_wh[..., None, 0],
                            gt_wh[..., None, 1])      # [B,H,W,A]
        best = prior_iou.argmax(dim=-1)                # [B,H,W]
        resp = torch.nn.functional.one_hot(best, a).to(predictions.dtype) * indicator[..., None]

        pos = ((txy - gt_xy[..., None, :]) ** 2).sum(-1)
        size = ((twh.sqrt() - gt_wh[..., None, :].sqrt()) ** 2).sum(-1)
        loss_coord = self.lambda_coord * (resp * (pos + size)).sum()

        pred_iou = _iou_wh(twh[..., 0], twh[..., 1], gt_wh[..., None, 0], gt_wh[..., None, 1])
        loss_obj = (resp * (conf - pred_iou) ** 2).sum()
        loss_noobj = self.lambda_noobj * ((1.0 - resp) * conf ** 2).sum()

        ce = -(gt_cls[..., None, :] * cls.clamp(1e-9, 1.0).log()).sum(-1)
        loss_cls = (resp * ce).sum()
        return (loss_coord + loss_obj + loss_noobj + loss_cls) / b

    def get_predicted_objects(self, predictions, threshold=0.5):
        """Detections above a confidence threshold (reference:
        YoloUtils.getPredictedObjects): a list per image of (confidence,
        cx, cy, w, h, class index), in grid units. The raw predictions come
        to the host once (bfloat16 widened to float32) and are decoded
        there, so the lists do not depend on the device the network ran
        on."""
        x = torch.as_tensor(predictions).detach()
        x = (x.float() if x.dtype == torch.bfloat16 else x).cpu()
        with torch.inference_mode():
            txy, twh, conf, cls = (t.numpy() for t in self._decode(x))
        out = []
        for bi in range(conf.shape[0]):
            dets = []
            ys, xs, ans = np.where(conf[bi] > threshold)
            for y, x, an in zip(ys, xs, ans):
                cx = x + txy[bi, y, x, an, 0]
                cy = y + txy[bi, y, x, an, 1]
                bw, bh = twh[bi, y, x, an]
                dets.append((float(conf[bi, y, x, an]), float(cx), float(cy),
                             float(bw), float(bh), int(np.argmax(cls[bi, y, x, an]))))
            out.append(dets)
        return out


def box_iou(box1, box2):
    """IoU of two (cx, cy, w, h) boxes (grid units)."""
    l1, r1 = box1[0] - box1[2] / 2, box1[0] + box1[2] / 2
    t1, b1 = box1[1] - box1[3] / 2, box1[1] + box1[3] / 2
    l2, r2 = box2[0] - box2[2] / 2, box2[0] + box2[2] / 2
    t2, b2 = box2[1] - box2[3] / 2, box2[1] + box2[3] / 2
    iw = max(0.0, min(r1, r2) - max(l1, l2))
    ih = max(0.0, min(b1, b2) - max(t1, t2))
    inter = iw * ih
    union = box1[2] * box1[3] + box2[2] * box2[3] - inter
    return inter / union if union > 0 else 0.0


def non_max_suppression(detections, iou_threshold=0.5):
    """Greedy per-class NMS over one image's (conf, cx, cy, w, h, class)
    detections, as ``get_predicted_objects`` gives them: keep the most
    confident box, drop same-class boxes overlapping it at or above the
    IoU threshold, repeat."""
    remaining = sorted(detections, key=lambda d: -d[0])
    kept = []
    while remaining:
        best = remaining.pop(0)
        kept.append(best)
        remaining = [d for d in remaining
                     if d[5] != best[5] or box_iou(best[1:5], d[1:5]) < iou_threshold]
    return kept
