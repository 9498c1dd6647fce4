"""SSD, the repo's detection model: the port's copy of
``examples/ssd_detection.py``'s ``ssd_symbol`` (JSON byte for byte) and
of its synthetic data recipe, ``make_dataset``.

A two-convolution backbone (16 and 32 filters, two 2 x 2 max pools),
``MultiBoxPrior`` anchors on the last feature map, class and box heads
(3 x 3 convolutions), ``MultiBoxTarget`` matching, a softmax class loss
and a smooth-L1 box loss, and ``MultiBoxDetection`` (decode + NMS) as a
blocked output.  At the example's 32 x 32 images the feature map is
8 x 8 and every image has 256 anchors.
"""
import numpy as np

from .. import recordio
from .. import symbol as sym


def get_symbol(num_classes=3, sizes=(0.3, 0.6), ratios=(1.0, 2.0, 0.5)):
    """Outputs: the class probabilities (SoftmaxOutput), the box loss,
    the class targets and the detections, the last two gradient-free."""
    data = sym.Variable("data")
    label = sym.Variable("label")
    # tiny backbone
    net = sym.Convolution(data, num_filter=16, kernel=(3, 3), pad=(1, 1),
                          name="c1")
    net = sym.Activation(net, act_type="relu")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = sym.Convolution(net, num_filter=32, kernel=(3, 3), pad=(1, 1),
                          name="c2")
    net = sym.Activation(net, act_type="relu")
    feat = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")

    num_anchors = len(sizes) + len(ratios) - 1
    anchors = sym.MultiBoxPrior(feat, sizes=list(sizes), ratios=list(ratios))
    cls_pred = sym.Convolution(feat, num_filter=num_anchors
                               * (num_classes + 1), kernel=(3, 3),
                               pad=(1, 1), name="cls_pred")
    loc_pred = sym.Convolution(feat, num_filter=num_anchors * 4,
                               kernel=(3, 3), pad=(1, 1), name="loc_pred")
    # (B, A*(C+1), H, W) -> (B, C+1, A*H*W): class-first for softmax axis 1
    cls_pred = sym.Reshape(sym.transpose(cls_pred, axes=(0, 2, 3, 1)),
                           shape=(0, -1, num_classes + 1))
    cls_pred = sym.transpose(cls_pred, axes=(0, 2, 1))
    loc_pred = sym.Flatten(sym.transpose(loc_pred, axes=(0, 2, 3, 1)))

    loc_target, loc_mask, cls_target = sym.MultiBoxTarget(
        anchors, label, cls_pred, name="target")
    cls_loss = sym.SoftmaxOutput(cls_pred, cls_target,
                                 multi_output=True, use_ignore=True,
                                 ignore_label=-1, name="cls_prob")
    loc_diff = loc_mask * (loc_pred - loc_target)
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_diff, scalar=1.0),
                            grad_scale=1.0, name="loc_loss")
    det = sym.MultiBoxDetection(cls_loss, loc_pred, anchors,
                                name="detection")
    return sym.Group([cls_loss, loc_loss,
                      sym.BlockGrad(cls_target), sym.BlockGrad(det)])


def make_dataset(path_prefix, n=64, size=32, seed=0):
    """Write ``path_prefix.rec`` / ``.idx``: ``n`` noise images of
    ``size`` x ``size`` with one axis-aligned bright rectangle each, whose
    color channel is its class (0-2); labels in the packed detection
    header [2, 5, cls, x0, y0, x1, y1], images through ``pack_img``'s
    ".png" path (the raw-array codec without cv2)."""
    rng = np.random.RandomState(seed)
    rec = recordio.MXIndexedRecordIO(path_prefix + ".idx",
                                     path_prefix + ".rec", "w")
    for i in range(n):
        img = rng.randint(0, 60, size=(size, size, 3), dtype=np.uint8)
        cls = rng.randint(0, 3)
        w, h = rng.randint(size // 4, size // 2, 2)
        x0 = rng.randint(0, size - w)
        y0 = rng.randint(0, size - h)
        img[y0:y0 + h, x0:x0 + w, cls] = 230
        box = [cls, x0 / size, y0 / size, (x0 + w) / size, (y0 + h) / size]
        label = np.concatenate([[2, 5], box]).astype(np.float32)
        rec.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, label, i, 0), img, img_fmt=".png",
            quality=3))
    rec.close()
