"""The port's contrib ops (``mxnet_tpu_torch/ops/contrib_ops.py``)
against the JAX package's, on the CPU.

Every case of ``test_torch_op_cases.CONTRIB`` runs through
``test_torch_ops_elemwise.run_case``: the forward of both packages on the
same seeded inputs (integer-valued outputs — class targets and masks,
detection class ids and row order — must come out equal, as every value
is held to rtol 1e-5 / atol 1e-6 and those are exact small integers),
the gradient where the JAX package's is not zero (CTCLoss, fft / ifft,
count_sketch; MultiBoxTarget's to the anchors and labels and
MultiBoxDetection's and Proposal's, through the box arithmetic, while
the sorts, thresholds and matches pass none) under the same seeded head
gradient, and the symbol's JSON, shapes and types.  MultiBoxDetection runs at A = 300 and at
A = 2100 (the JAX package's ``lax.map`` branch), with and without
``nms_topk`` and ``force_suppress``.  The remaining tests are
``tests/test_spatial_contrib.py``'s MultiBox, Proposal and CTC cases
through both packages.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import registry as treg
from test_torch_op_cases import CONTRIB, CONTRIB_LARGE, SPATIAL
from test_torch_ops_elemwise import run_case


@pytest.mark.parametrize("case", sorted(CONTRIB))
def test_contrib_op(case):
    op, arrays, attrs, grad = CONTRIB[case]
    run_case(op, arrays, attrs, grad=grad)


SLICE_NAMES = (
    # ops/contrib_ops.py
    "CTCLoss", "MultiBoxDetection", "MultiBoxPrior", "MultiBoxTarget",
    "Proposal", "_contrib_CTCLoss", "_contrib_MultiBoxDetection",
    "_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget", "_contrib_Proposal",
    "_contrib_count_sketch", "_contrib_dequantize", "_contrib_fft",
    "_contrib_ifft", "_contrib_quantize", "count_sketch", "ctc_loss",
    "dequantize", "fft", "ifft", "quantize",
    # ops/spatial.py
    "BilinearSampler", "Correlation", "Crop", "GridGenerator", "ROIPooling",
    "SpatialTransformer")


def test_every_contrib_and_spatial_op_has_a_case():
    """The slice's 27 names (16 ops) are registered, each op runs in a
    case of CONTRIB or SPATIAL, and the large cases name registered
    ops."""
    ops = {id(treg.get_op(n)) for n in SLICE_NAMES}
    ran = {id(treg.get_op(c[0])) for t in (CONTRIB, SPATIAL)
           for c in t.values()}
    assert len(SLICE_NAMES) == 27 and len(ops) == 16
    assert ops == ran
    assert all(treg.get_op(c[0]) for c in CONTRIB_LARGE.values())


def _both(fn):
    """``fn(pkg)`` run in the JAX package and (on the host) in the port,
    every output as numpy."""
    def run(pkg):
        outs = fn(pkg)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        return [o.asnumpy() for o in outs]

    want = run(mx)
    with mt.cpu():
        got = run(mt)
    return got, want


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_forced_match_survives_padding():
    """A gt whose best anchor is index 0 keeps its forced match though
    the padding rows argmax to anchor 0 too."""
    anchors = np.array([[[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.9, 0.9]]],
                       np.float32)
    gt = np.array([[[0, 0.0, 0.0, 0.05, 0.05], [-1, 0, 0, 0, 0],
                    [-1, 0, 0, 0, 0]]], np.float32)
    got, want = _both(lambda p: p.nd.MultiBoxTarget(
        p.nd.array(anchors), p.nd.array(gt), p.nd.zeros((1, 2, 2)),
        overlap_threshold=0.5))
    _assert_same(got, want)
    assert got[2][0, 0] == 1.0


def test_hard_negative_mining_picks_the_hardest():
    """ratio 1: as many mined negatives as positives, the hardest ones
    (lowest background probability); the other unmatched are ignored."""
    def fn(p):
        anchors = p.nd.MultiBoxPrior(p.nd.zeros((1, 3, 4, 4)), sizes=(0.4,))
        gt = np.array([[[0, 0.1, 0.1, 0.4, 0.4], [1, 0.6, 0.6, 0.9, 0.9],
                        [-1, 0, 0, 0, 0]]], np.float32)
        preds = np.zeros((1, 3, 16), np.float32)
        preds[0, 0, :] = 4.0
        preds[0, 0, [3, 7, 11]] = -4.0
        return p.nd.MultiBoxTarget(anchors, p.nd.array(gt),
                                   p.nd.array(preds),
                                   negative_mining_ratio=1.0)
    got, want = _both(fn)
    _assert_same(got, want)
    cls = got[2][0]
    assert (cls == 0).sum() == (cls > 0).sum()


def test_per_class_nms_and_force_suppress():
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.12, 0.12, 0.52, 0.52]]],
                       np.float32)
    probs = np.array([[[0.1, 0.1], [0.9, 0.0], [0.0, 0.9]]], np.float32)
    for force in (False, True):
        got, want = _both(lambda p: p.nd.MultiBoxDetection(
            p.nd.array(probs), p.nd.zeros((1, 8)), p.nd.array(anchors),
            force_suppress=force))
        _assert_same(got, want)
        assert (got[0][0, :, 0] >= 0).sum() == (1 if force else 2)


def test_target_detection_round_trip():
    """Perfect localization decodes back onto the ground truth, rows and
    order as the JAX package gives them."""
    def fn(p):
        anchors = p.nd.MultiBoxPrior(p.nd.zeros((1, 3, 4, 4)), sizes=(0.4,))
        gt = np.array([[[0, 0.1, 0.1, 0.4, 0.4], [1, 0.6, 0.6, 0.9, 0.9],
                        [-1, 0, 0, 0, 0]]], np.float32)
        loc_t, _, cls_t = p.nd.MultiBoxTarget(anchors, p.nd.array(gt),
                                              p.nd.zeros((1, 3, 16)))
        cls = cls_t.asnumpy()
        probs = np.zeros((1, 3, 16), np.float32)
        probs[0, 0] = 1.0
        for a in np.nonzero(cls[0])[0]:
            probs[0, int(cls[0, a]), a] = 0.9
            probs[0, 0, a] = 0.1
        return p.nd.MultiBoxDetection(p.nd.array(probs),
                                      loc_t.reshape((1, -1)), anchors)
    got, want = _both(fn)
    _assert_same(got, want)
    assert (got[0][0, :, 0] >= 0).sum() >= 2


def test_proposal_pads_by_cycling_the_kept_boxes():
    rng = np.random.RandomState(3)
    cls_prob = rng.rand(1, 24, 4, 4).astype(np.float32)
    got, want = _both(lambda p: p.nd.Proposal(
        p.nd.array(cls_prob), p.nd.zeros((1, 48, 4, 4)),
        p.nd.array(np.array([[64, 64, 1.0]], np.float32)),
        rpn_pre_nms_top_n=2, rpn_post_nms_top_n=8, threshold=0.01))
    _assert_same(got, want)
    assert len(np.unique(got[0][:, 1:], axis=0)) <= 2


def test_ctc_gradient_through_a_module():
    """CTCLoss under MakeLoss in a bound symbol: the data gradient the
    executor's backward gives, in both packages."""
    acts = np.random.RandomState(5).randn(4, 2, 4).astype(np.float32)
    labels = np.array([[1, 2], [3, 0]], np.float32)

    def fn(p):
        net = p.sym.MakeLoss(p.sym.sum(p.sym.CTCLoss(
            p.sym.Variable("data"), p.sym.Variable("label"))))
        ex = net.bind(p.cpu(), {"data": p.nd.array(acts),
                                "label": p.nd.array(labels)},
                      args_grad={"data": p.nd.zeros(acts.shape)},
                      grad_req={"data": "write", "label": "null"})
        out = ex.forward(is_train=True)
        ex.backward()
        return out + [ex.grad_dict["data"]]
    got, want = _both(fn)
    _assert_same(got, want)
