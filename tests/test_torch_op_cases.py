"""The op cases of the imperative and detection slices: every op of
``mxnet_tpu/ops/elemwise.py``, ``tensor.py``, ``nn.py``,
``contrib_ops.py`` and ``spatial.py`` that the port gained, with seeded
numpy inputs away from each op's kinks and ties.  Data only (no tests,
no JAX import): ``test_torch_ops_elemwise.py`` / ``_tensor.py`` /
``_nn.py`` / ``test_torch_contrib.py`` / ``test_torch_spatial.py`` hold
each case against the JAX package on the CPU, ``test_torch_cuda.py``
and ``chip_smoke.py``'s ``ops`` phase hold it on the card against the
CPU (the phase also runs ``CONTRIB_LARGE``, the detection scale's
Proposal).

``NEW_NAMES`` are the 163 op names the slice adds; every op they name
is run by a case or a sampler (``test_torch_ops_elemwise.py`` checks).
A case is ``(op, arrays, attrs, grad)``: ``grad`` names the inputs
whose gradient is held (under a seeded head gradient).  ``CONV_OPS`` sum up to 36 products a value and take 1e-5
absolute as well as relative.  :func:`run_port` / :func:`draw_port` run
a case / a sampler on the port on any context.
"""
import threading

import numpy as np


def _x(seed, shape=(3, 4), lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _ids(values):
    return np.asarray(values, np.float32)


def _away(x, gap=0.3):
    """Keep away from 0 (the kinks of abs, relu, sign)."""
    return (x + np.sign(x) * gap).astype(np.float32)


def _half(x):
    """Keep away from .5 (the roundings' ties)."""
    return (np.floor(x) + 0.25 + 0.5 * (x - np.floor(x) > 0.5)) \
        .astype(np.float32)


def _seed(name):
    return sum(map(ord, name))


CONV_OPS = ("Deconvolution", "Convolution")

NEW_NAMES = (
    "BlockGrad", "Cast", "Deconvolution", "ElementWiseSum",
    "IdentityAttachKLSparseReg", "InstanceNorm", "L2Normalization",
    "LeakyReLU", "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "MakeLoss", "Pad", "SVMOutput", "SequenceLast",
    "SequenceMask", "SequenceReverse", "SoftmaxActivation", "UpSampling",
    "_arange", "_copy", "_crop_assign", "_crop_assign_scalar", "_equal",
    "_equal_scalar", "_grad_add", "_greater", "_greater_equal",
    "_greater_equal_scalar", "_greater_scalar", "_hypot", "_hypot_scalar",
    "_identity_with_attr_like_rhs", "_lesser", "_lesser_equal",
    "_lesser_equal_scalar", "_lesser_scalar", "_maximum", "_maximum_scalar",
    "_minimum", "_minimum_scalar", "_mod", "_mod_scalar", "_not_equal",
    "_not_equal_scalar", "_ones", "_rmod_scalar", "_sample_exponential",
    "_sample_gamma", "_sample_generalized_negative_binomial",
    "_sample_negative_binomial", "_sample_normal", "_sample_poisson",
    "_sample_uniform", "_slice_assign", "_slice_assign_scalar", "_sum",
    "_zeros", "abs", "add_n", "arccos", "arccosh", "arcsin", "arcsinh",
    "arctan", "arctanh", "argmax", "argmax_channel", "argmin", "argsort",
    "batch_dot", "batch_take", "broadcast_axes", "broadcast_axis",
    "broadcast_equal", "broadcast_greater", "broadcast_greater_equal",
    "broadcast_hypot", "broadcast_lesser", "broadcast_lesser_equal",
    "broadcast_maximum", "broadcast_minimum", "broadcast_mod",
    "broadcast_not_equal", "broadcast_to", "cast", "cbrt", "ceil", "clip",
    "cos", "cosh", "crop", "degrees", "dot", "elemwise_sum", "erf", "exp",
    "expm1", "fix", "flip", "floor", "gamma", "gammaln", "identity", "log",
    "log10", "log1p", "log2", "log_softmax", "logical_not", "make_loss",
    "max", "max_axis", "min", "min_axis", "nanprod", "nansum", "negative",
    "norm", "normal", "one_hot", "pad", "pick", "prod", "radians",
    "random_exponential", "random_gamma",
    "random_generalized_negative_binomial", "random_negative_binomial",
    "random_normal", "random_poisson", "random_uniform", "rcbrt",
    "reciprocal", "relu", "repeat", "reverse", "rint", "round", "sigmoid",
    "sign", "sin", "sinh", "slice", "slice_axis", "smooth_l1", "softmax",
    "softmax_cross_entropy", "softrelu", "softsign", "sort", "sqrt",
    "stop_gradient", "sum", "sum_axis", "take", "tan", "tanh", "tile",
    "topk", "transpose", "trunc", "uniform")

# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

# domain transforms keep each op's input valid and off its kinks
UNARY = {
    "abs": _away, "sign": _away, "rint": _half, "ceil": _half,
    "floor": _half, "trunc": _half, "fix": _half, "round": _half,
    "square": None, "sqrt": lambda x: np.abs(x) + 0.2,
    "rsqrt": lambda x: np.abs(x) + 0.5, "cbrt": _away,
    "rcbrt": lambda x: np.abs(x) + 0.5, "exp": None,
    "log": lambda x: np.abs(x) + 0.5, "log10": lambda x: np.abs(x) + 0.5,
    "log2": lambda x: np.abs(x) + 0.5, "log1p": np.abs, "expm1": None,
    "sin": None, "cos": None, "tan": lambda x: np.clip(x, -1.2, 1.2),
    "arcsin": lambda x: np.clip(x, -0.9, 0.9),
    "arccos": lambda x: np.clip(x, -0.9, 0.9), "arctan": None,
    "sinh": None, "cosh": None, "tanh": None, "arcsinh": None,
    "arccosh": lambda x: np.abs(x) + 1.1,
    "arctanh": lambda x: np.clip(x, -0.9, 0.9), "degrees": None,
    "radians": None, "gamma": lambda x: np.abs(x) + 1.0,
    "gammaln": lambda x: np.abs(x) + 1.0, "erf": None, "negative": None,
    "reciprocal": lambda x: np.abs(x) + 0.5, "sigmoid": None,
    "relu": _away, "softsign": _away, "softrelu": None,
    "logical_not": np.round, "_copy": None, "BlockGrad": None,
}
BINARY = ("plus", "minus", "mul", "div", "mod", "power", "maximum",
          "minimum", "hypot")
# the reference registers _r<name>_scalar for these only
RSCALAR = ("minus", "div", "power", "mod")
LOGIC = ("equal", "not_equal", "greater", "greater_equal", "lesser",
         "lesser_equal")


def _pair(name, broadcast):
    a = _x(1)
    b = _x(2, (1, 4) if broadcast else (3, 4))
    if name in ("div", "mod"):
        b = _away(b, 0.5)
    if name == "power":
        a = np.abs(a) + 0.5
    if name == "mod":
        a = (a * 3).astype(np.float32)
    return a, b


def _elemwise():
    cases = {}
    for op, dom in UNARY.items():
        x = _x(_seed(op))
        cases[op] = (op, [x if dom is None else dom(x).astype(np.float32)],
                     {}, (0,))
    for name in BINARY:
        canon = {"plus": "add", "minus": "sub"}.get(name, name)
        cases["_" + name] = ("_" + name, list(_pair(name, False)), {},
                             (0, 1))
        cases["broadcast_" + canon] = ("broadcast_" + canon,
                                       list(_pair(name, True)), {}, (0, 1))
        for side in ("", "r") if name in RSCALAR else ("",):
            a = _x(3)
            if name == "power" or side == "r" and name in ("div", "mod"):
                a = (np.abs(a) + 0.5).astype(np.float32)
            op = "_%s%s_scalar" % (side, name)
            cases[op] = (op, [a], {"scalar": 1.7}, (0,))
    a = np.round(_x(4) * 2).astype(np.float32)
    b = np.round(_x(5, (1, 4)) * 2).astype(np.float32)
    for name in LOGIC:
        cases["broadcast_" + name] = ("broadcast_" + name, [a, b], {},
                                      (0, 1))
        cases["_" + name] = ("_" + name, [a, b[[0, 0, 0]]], {}, ())
        cases["_%s_scalar" % name] = ("_%s_scalar" % name, [a],
                                      {"scalar": 1.0}, ())
    for dt in ("float16", "int32", "float64"):
        cases["Cast_" + dt] = ("Cast", [(_x(6) * 3).astype(np.float32)],
                               {"dtype": dt}, ())
    clip_x = _x(7)
    cases.update({
        "smooth_l1": ("smooth_l1", [_x(7)], {"scalar": 1.5}, (0,)),
        "add_n": ("add_n", [_x(7), _x(8), _x(9)], {}, (0, 1, 2)),
        "ElementWiseSum": ("ElementWiseSum", [_x(7), _x(8)], {}, (0, 1)),
        "clip": ("clip", [np.where(np.abs(clip_x - 1.1) < 0.05, 0.0, clip_x)
                          .astype(np.float32)],
                 {"a_min": -0.7, "a_max": 1.1}, (0,)),
        "_grad_add": ("_grad_add", [_x(7), _x(8)], {}, (0, 1)),
        "_identity_with_attr_like_rhs": ("_identity_with_attr_like_rhs",
                                         [_x(7), _x(8)], {}, (0,)),
    })
    return cases


ELEMWISE = _elemwise()

# ---------------------------------------------------------------------------
# tensor
# ---------------------------------------------------------------------------

X3 = _x(11, (2, 3, 4))
NANS = np.where(_x(12) > 1.2, np.nan, _x(13)).astype(np.float32)
POS = (np.abs(_x(14)) + 0.5).astype(np.float32)

TENSOR = {
    # reductions
    "sum": ("sum", [X3], {}, (0,)),
    "sum_axis_keep": ("sum", [X3], {"axis": 1, "keepdims": True}, (0,)),
    "sum_exclude": ("sum_axis", [X3], {"axis": (0,), "exclude": True},
                    (0,)),
    "prod": ("prod", [POS], {"axis": 1}, (0,)),
    "prod_all": ("prod", [POS], {}, (0,)),
    "nansum": ("nansum", [NANS], {"axis": 0}, (0,)),
    "nanprod": ("nanprod", [NANS], {"axis": 1, "keepdims": True}, (0,)),
    "max": ("max", [X3], {"axis": (0, 2)}, (0,)),
    "max_axis": ("max_axis", [X3], {"axis": 2, "keepdims": True}, (0,)),
    "min": ("min", [X3], {}, (0,)),
    "min_axis": ("min_axis", [X3], {"axis": 1}, (0,)),
    "norm": ("norm", [X3], {}, (0,)),
    "argmax": ("argmax", [X3], {"axis": 1}, ()),
    "argmax_flat": ("argmax", [X3], {}, ()),
    "argmin_keep": ("argmin", [X3], {"axis": 2, "keepdims": True}, ()),
    "argmax_channel": ("argmax_channel", [X3], {}, ()),
    # broadcasting
    "broadcast_to": ("broadcast_to", [_x(15, (3, 1))], {"shape": (0, 4)},
                     (0,)),
    "broadcast_axis": ("broadcast_axis", [_x(16, (1, 4, 1))],
                       {"axis": (0, 2), "size": (3, 2)}, (0,)),
    "broadcast_axes": ("broadcast_axes", [_x(16, (3, 1))],
                       {"axis": 1, "size": 5}, (0,)),
    # shapes and copies
    "transpose": ("transpose", [X3], {}, (0,)),
    "transpose_axes": ("transpose", [X3], {"axes": (1, 0, 2)}, (0,)),
    "slice": ("slice", [X3], {"begin": (0, 1, 1), "end": (2, 3, 3)}, (0,)),
    "crop": ("crop", [_x(17)], {"begin": (1, 0), "end": (3, 2)}, (0,)),
    "_slice_assign": ("_slice_assign", [_x(18), _x(19, (2, 2))],
                      {"begin": (1, 1), "end": (3, 3)}, (0, 1)),
    "_crop_assign_scalar": ("_crop_assign_scalar", [_x(20)],
                            {"begin": (0, 1), "end": (2, 3),
                             "scalar": 2.5}, (0,)),
    "slice_axis": ("slice_axis", [X3], {"axis": 2, "begin": 1, "end": 3},
                   (0,)),
    "slice_axis_tail": ("slice_axis", [X3],
                        {"axis": -1, "begin": -3, "end": None}, (0,)),
    "repeat": ("repeat", [_x(21)], {"repeats": 2, "axis": 1}, (0,)),
    "repeat_flat": ("repeat", [_x(21)], {"repeats": 3}, (0,)),
    "tile": ("tile", [_x(22)], {"reps": (2, 1)}, (0,)),
    "tile_prepend": ("tile", [_x(22)], {"reps": (2, 1, 3)}, (0,)),
    "reverse": ("reverse", [X3], {"axis": (0, 2)}, (0,)),
    "flip": ("flip", [_x(23)], {"axis": (1,)}, (0,)),
    # products
    "dot": ("dot", [_x(24, (3, 4)), _x(25, (4, 5))], {}, (0, 1)),
    "dot_ta": ("dot", [_x(24, (4, 3)), _x(25, (4, 5))],
               {"transpose_a": True}, (0, 1)),
    "dot_tb": ("dot", [_x(24, (3, 4)), _x(25, (5, 4))],
               {"transpose_b": True}, (0, 1)),
    "dot_vec": ("dot", [_x(26, (4,)), _x(27, (4,))], {}, (0, 1)),
    "batch_dot": ("batch_dot", [_x(28, (2, 3, 4)), _x(29, (2, 4, 5))], {},
                  (0, 1)),
    "batch_dot_tb": ("batch_dot", [_x(28, (2, 3, 4)), _x(29, (2, 5, 4))],
                     {"transpose_b": True}, (0, 1)),
    # indexing
    "take": ("take", [_x(30, (5, 3)), _ids([[0, 4], [2, 2]])], {}, (0,)),
    "take_clip": ("take", [_x(30, (5, 3)), _ids([7, -2, 1])],
                  {"axis": 0, "mode": "clip"}, (0,)),
    "take_wrap": ("take", [_x(30, (3, 5)), _ids([7, -2, 1])],
                  {"axis": 1, "mode": "wrap"}, (0,)),
    "batch_take": ("batch_take", [_x(31, (4, 5)), _ids([0, 4, 2, 1])], {},
                   (0,)),
    "one_hot": ("one_hot", [_ids([0, 3, 1, 4])], {"depth": 5}, ()),
    "one_hot_values": ("one_hot", [_ids([[1, 0], [2, 6]])],
                       {"depth": 3, "on_value": 2.5, "off_value": -1.0},
                       ()),
    "pick": ("pick", [_x(32), _ids([0, 3, 1])], {}, (0,)),
    "pick_axis0": ("pick", [_x(32), _ids([2, 0, 1, 1])],
                   {"axis": 0, "keepdims": True}, (0,)),
    # constructors
    "_zeros": ("_zeros", [], {"shape": (2, 3)}, ()),
    "_ones": ("_ones", [], {"shape": (4,), "dtype": "float64"}, ()),
    "_arange": ("_arange", [], {"start": 1.0, "stop": 7.0, "step": 1.5},
                ()),
    "_arange_repeat": ("_arange", [], {"start": 3.0, "repeat": 2}, ()),
    # ordering
    "topk": ("topk", [X3], {"k": 2}, ()),
    "topk_value": ("topk", [X3], {"k": 3, "ret_typ": "value"}, (0,)),
    "topk_both_ascend": ("topk", [X3], {"k": 2, "ret_typ": "both",
                                        "is_ascend": True, "axis": 1},
                         (0,)),
    "topk_mask": ("topk", [X3], {"k": 2, "ret_typ": "mask", "axis": 0}, ()),
    "sort": ("sort", [X3], {}, (0,)),
    "sort_desc": ("sort", [X3], {"axis": 1, "is_ascend": False}, (0,)),
    "sort_flat": ("sort", [X3], {"axis": None}, (0,)),
    "argsort": ("argsort", [X3], {"axis": 0}, ()),
    "argsort_desc": ("argsort", [X3], {"is_ascend": False}, ()),
    # softmax family
    "softmax": ("softmax", [X3], {}, (0,)),
    "softmax_axis": ("softmax", [X3], {"axis": 1}, (0,)),
    "log_softmax": ("log_softmax", [X3], {"axis": 0}, (0,)),
    "softmax_cross_entropy": ("softmax_cross_entropy",
                              [_x(33, (4, 5)), _ids([0, 4, 2, 2])], {},
                              (0,)),
}

# ---------------------------------------------------------------------------
# nn (the loss heads ignore the head gradient: their cases hold the
# reference's own gradients)
# ---------------------------------------------------------------------------

IMG = _x(40, (2, 3, 5, 4))
SEQ = _x(41, (5, 3, 2))
LENS = _ids([2, 5, 3])

NN = {
    "leaky": ("LeakyReLU", [_away(IMG)], {"slope": 0.1}, (0,)),
    "rrelu": ("LeakyReLU", [_away(IMG)], {"act_type": "rrelu"}, (0,)),
    "elu": ("LeakyReLU", [_away(IMG)], {"act_type": "elu", "slope": 0.7},
            (0,)),
    "prelu": ("LeakyReLU", [_away(IMG), _x(42, (3,))],
              {"act_type": "prelu"}, (0, 1)),
    "softmax_instance": ("SoftmaxActivation", [IMG], {}, (0,)),
    "softmax_channel": ("SoftmaxActivation", [IMG], {"mode": "channel"},
                        (0,)),
    "deconv": ("Deconvolution", [IMG, _x(43, (3, 4, 3, 3)), _x(44, (4,))],
               {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                "adj": (1, 0), "num_filter": 4, "no_bias": False},
               (0, 1, 2)),
    "deconv_target": ("Deconvolution", [IMG, _x(45, (3, 2, 4, 3))],
                      {"kernel": (4, 3), "stride": (2, 2),
                       "target_shape": (10, 9), "num_filter": 2}, (0, 1)),
    "deconv_groups": ("Deconvolution", [_x(46, (2, 4, 3, 3)),
                                        _x(47, (4, 3, 2, 2))],
                      {"kernel": (2, 2), "num_filter": 6, "num_group": 2},
                      (0, 1)),
    "instance_norm": ("InstanceNorm", [IMG, _x(48, (3,)), _x(49, (3,))],
                      {"eps": 1e-3}, (0, 1, 2)),
    "l2_instance": ("L2Normalization", [IMG], {}, (0,)),
    "l2_channel": ("L2Normalization", [IMG], {"mode": "channel"}, (0,)),
    "l2_spatial": ("L2Normalization", [IMG], {"mode": "spatial"}, (0,)),
    "pad_constant": ("Pad", [IMG], {"pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                                    "constant_value": 0.5}, (0,)),
    "pad_edge": ("pad", [IMG], {"mode": "edge",
                                "pad_width": (0, 0, 0, 0, 2, 1, 0, 3)},
                 (0,)),
    "pad_reflect": ("Pad", [IMG], {"mode": "reflect",
                                   "pad_width": (0, 0, 0, 0, 1, 2, 3, 1)},
                    (0,)),
    "upsampling_nearest": ("UpSampling", [IMG], {"scale": 2}, (0,)),
    "upsampling_bilinear": ("UpSampling", [IMG],
                            {"scale": 3, "sample_type": "bilinear"}, (0,)),
    "sequence_last": ("SequenceLast", [SEQ], {}, (0,)),
    "sequence_last_lens": ("SequenceLast", [SEQ, LENS],
                           {"use_sequence_length": True}, (0,)),
    "sequence_mask": ("SequenceMask", [SEQ, LENS],
                      {"use_sequence_length": True, "value": -1.5}, (0,)),
    "sequence_mask_off": ("SequenceMask", [SEQ], {}, (0,)),
    "sequence_reverse": ("SequenceReverse", [SEQ], {}, (0,)),
    "sequence_reverse_lens": ("SequenceReverse", [SEQ, LENS],
                              {"use_sequence_length": True}, (0,)),
    "kl_sparse_reg": ("IdentityAttachKLSparseReg", [IMG], {}, (0,)),
    "linear_regression": ("LinearRegressionOutput",
                          [_x(50, (4, 3)), _x(51, (4, 3))],
                          {"grad_scale": 2.0}, (0,)),
    "logistic_regression": ("LogisticRegressionOutput",
                            [_x(50, (4, 3)), _x(52, (4, 3), 0.0, 1.0)], {},
                            (0,)),
    "mae_regression": ("MAERegressionOutput",
                       [_x(50, (4, 3)), _x(53, (4, 3))], {}, (0,)),
    "make_loss": ("MakeLoss", [_x(54, (4, 3))], {"grad_scale": 0.5}, (0,)),
    "make_loss_batch": ("make_loss", [_x(54, (4, 3))],
                        {"normalization": "batch"}, (0,)),
    "make_loss_valid": ("MakeLoss", [_x(54, (4, 3))],
                        {"normalization": "valid", "valid_thresh": 0.5},
                        (0,)),
    "svm_l2": ("SVMOutput", [_x(55, (4, 5)), _ids([0, 4, 2, 1])],
               {"margin": 1.5}, (0,)),
    "svm_l1": ("SVMOutput", [_x(55, (4, 5)), _ids([3, 0, 2, 2])],
               {"use_linear": True, "regularization_coefficient": 0.5},
               (0,)),
    # NHWC: the weight stays OIHW
    "conv_nhwc": ("Convolution", [_x(56, (2, 5, 4, 3)),
                                  _x(57, (4, 3, 3, 3)), _x(58, (4,))],
                  {"kernel": (3, 3), "pad": (1, 1), "stride": (2, 1),
                   "num_filter": 4, "layout": "NHWC"}, (0, 1, 2)),
    "conv_nhwc_groups": ("Convolution", [_x(59, (2, 5, 4, 4)),
                                         _x(60, (6, 2, 1, 3))],
                         {"kernel": (1, 3), "num_filter": 6,
                          "num_group": 2, "no_bias": True,
                          "layout": "NHWC"}, (0, 1)),
    "pool_max_nhwc": ("Pooling", [_x(61, (2, 5, 4, 3))],
                      {"kernel": (2, 2), "stride": (2, 2),
                       "pooling_convention": "full", "layout": "NHWC"},
                      (0,)),
    "pool_avg_nhwc": ("Pooling", [_x(62, (2, 5, 4, 3))],
                      {"kernel": (3, 3), "pad": (1, 1), "pool_type": "avg",
                       "layout": "NHWC"}, (0,)),
    "pool_global_nhwc": ("Pooling", [_x(63, (2, 5, 4, 3))],
                         {"kernel": (1, 1), "global_pool": True,
                          "pool_type": "sum", "layout": "NHWC"}, (0,)),
}

# ---------------------------------------------------------------------------
# contrib and spatial (the detection slice).  The MultiBox cases take
# seeded random boxes and softmax scores with a background bias, so the
# suppression and the score threshold both bite; A = 2100 reaches the
# JAX package's lax.map branch (A > 2048)
# ---------------------------------------------------------------------------

def _boxes(seed, n, lo=0.05, hi=0.4):
    """``n`` corner boxes inside the unit square, sides in [lo, hi)."""
    rng = np.random.RandomState(seed)
    wh = rng.uniform(lo, hi, (n, 2))
    x0 = rng.uniform(0, 1, n) * (1 - wh[:, 0])
    y0 = rng.uniform(0, 1, n) * (1 - wh[:, 1])
    return np.stack([x0, y0, x0 + wh[:, 0], y0 + wh[:, 1]],
                    axis=1).astype(np.float32)


def _det_inputs(seed, n, classes, a):
    """MultiBoxDetection's (cls_prob, loc_pred, anchors): softmax scores
    over classes + 1 with the background logit raised by 1."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, classes + 1, a)
    logits[:, 0] += 1.0
    prob = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    loc = (rng.randn(n, a * 4) * 0.1).astype(np.float32)
    return [prob.astype(np.float32), loc, _boxes(seed + 1, a)[None]]


def _det_labels(seed, n, rows, anchors):
    """(N, rows, 5) ground truth: 1..rows - 1 real boxes an image (each
    near an anchor, so some match above the threshold), -1 padding."""
    rng = np.random.RandomState(seed)
    out = np.full((n, rows, 5), -1.0, np.float32)
    for i in range(n):
        k = rng.randint(1, rows)
        pick = anchors[rng.choice(len(anchors), k, replace=False)]
        jitter = rng.uniform(-0.03, 0.03, (k, 4))
        box = np.clip(pick + jitter, 0.0, 1.0)
        box[:, 2:] = np.maximum(box[:, 2:], box[:, :2] + 0.02)
        out[i, :k, 0] = rng.randint(0, 3, k)
        out[i, :k, 1:] = box
    return out


ANCHORS = _boxes(70, 64)[None]
DET = _det_inputs(71, 2, 3, 300)
DET_2100 = _det_inputs(72, 2, 3, 2100)
CTC_ACTS = _x(73, (6, 3, 5))
CTC_LABELS = _ids([[1, 2], [3, 0], [4, 4]])
SKETCH_H = _ids(np.random.RandomState(74).randint(0, 6, 10))
SKETCH_S = _ids(np.random.RandomState(75).choice([-1.0, 1.0], 10))


def _rpn(seed, k, h, w, scale=0.1):
    """Proposal's (cls_prob, bbox_pred) for k anchors on an h x w map."""
    rng = np.random.RandomState(seed)
    return [rng.rand(1, 2 * k, h, w).astype(np.float32),
            (rng.randn(1, 4 * k, h, w) * scale).astype(np.float32)]


CONTRIB = {
    "multibox_prior": ("MultiBoxPrior", [np.zeros((1, 3, 4, 5), np.float32)],
                       {"sizes": (0.5, 0.25), "ratios": (1.0, 2.0, 0.5)},
                       ()),
    "multibox_prior_steps": ("_contrib_MultiBoxPrior",
                             [np.zeros((2, 3, 3, 2), np.float32)],
                             {"sizes": (0.9, 0.3), "ratios": (1.0, 3.0),
                              "clip": True, "steps": (0.3, 0.2),
                              "offsets": (0.4, 0.6)}, ()),
    "multibox_target": ("MultiBoxTarget",
                        [ANCHORS, _det_labels(76, 2, 4, ANCHORS[0]),
                         _x(77, (2, 4, 64))], {}, (0, 1, 2)),
    "multibox_target_mining": ("_contrib_MultiBoxTarget",
                               [ANCHORS, _det_labels(78, 3, 5, ANCHORS[0]),
                                _x(79, (3, 4, 64))],
                               {"negative_mining_ratio": 3.0,
                                "negative_mining_thresh": 0.5,
                                "overlap_threshold": 0.4,
                                "variances": (0.1, 0.1, 0.2, 0.2)}, ()),
    "multibox_detection": ("MultiBoxDetection", DET,
                           {"nms_threshold": 0.45}, (0, 1, 2)),
    "multibox_detection_topk": ("MultiBoxDetection", DET,
                                {"nms_threshold": 0.45, "nms_topk": 40},
                                (0, 1, 2)),
    "multibox_detection_force": ("_contrib_MultiBoxDetection", DET,
                                 {"nms_threshold": 0.3,
                                  "force_suppress": True,
                                  "threshold": 0.2}, ()),
    "multibox_detection_2100": ("MultiBoxDetection", DET_2100,
                                {"nms_threshold": 0.45}, ()),
    "multibox_detection_2100_topk": ("MultiBoxDetection", DET_2100,
                                     {"nms_threshold": 0.45, "nms_topk": 400,
                                      "force_suppress": True}, ()),
    "proposal": ("Proposal", _rpn(80, 12, 4, 5)
                 + [np.array([[64, 80, 1.0]], np.float32)],
                 {"rpn_pre_nms_top_n": 50, "rpn_post_nms_top_n": 20,
                  "threshold": 0.5, "rpn_min_size": 8}, (0, 1, 2)),
    "proposal_scaled": ("_contrib_Proposal", _rpn(81, 6, 3, 4, 0.2)
                        + [np.array([[48, 64, 2.0]], np.float32)],
                        {"scales": (2.0, 4.0, 8.0), "ratios": (0.5, 2.0),
                         "feature_stride": 8, "rpn_pre_nms_top_n": 30,
                         "rpn_post_nms_top_n": 40, "threshold": 0.6}, ()),
    "ctc": ("CTCLoss", [CTC_ACTS, CTC_LABELS], {}, (0,)),
    "ctc_loss": ("ctc_loss", [_x(82, (5, 2, 4)), _ids([[1, 1], [2, 3]])], {},
                 (0,)),
    "fft": ("fft", [_x(83, (3, 8))], {}, (0,)),
    "ifft": ("_contrib_ifft", [_x(84, (2, 3, 12))], {}, (0,)),
    "quantize": ("quantize", [_x(85, (4, 5), -3.0, 3.0),
                              np.float32([-3.0]), np.float32([3.0])], {},
                 ()),
    "dequantize": ("_contrib_dequantize",
                   [np.random.RandomState(86).randint(0, 256, (4, 5))
                    .astype(np.uint8), np.float32([-2.0]),
                    np.float32([3.0])], {}, ()),
    "count_sketch": ("count_sketch", [_x(87, (3, 10)), SKETCH_H, SKETCH_S],
                     {"out_dim": 6}, (0,)),
}

# the detection scale's RPN (a 38 x 50 map, 12 anchors: 22,800 boxes
# through a full NMS): the card against the host only (chip_smoke.py's
# ops phase), too large for a parity run against the JAX package here
CONTRIB_LARGE = {
    "proposal_38x50": ("Proposal", _rpn(88, 12, 38, 50)
                       + [np.array([[600, 800, 1.0]], np.float32)],
                       {"rpn_pre_nms_top_n": 6000,
                        "rpn_post_nms_top_n": 300}, ()),
}

ROI_DATA = _x(90, (2, 3, 12, 12))
ROIS = _ids([[0, 0, 0, 11, 11], [1, 2, 2, 9, 9], [0, 4, 4, 7, 7],
             [1, 3, 5, 11, 8]])
THETA = (np.array([[0.8, 0.1, 0.05, -0.1, 0.9, 0.02],
                   [1.1, -0.2, 0.1, 0.15, 0.7, -0.05]], np.float32))

SPATIAL = {
    "roi_pooling": ("ROIPooling", [ROI_DATA, ROIS],
                    {"pooled_size": (4, 4), "spatial_scale": 1.0}, (0,)),
    # scale 0.5 puts corners on .5: C rounding (away from zero) decides
    "roi_pooling_half": ("ROIPooling", [ROI_DATA, ROIS],
                         {"pooled_size": (3, 2), "spatial_scale": 0.5},
                         (0,)),
    "grid_affine": ("GridGenerator", [THETA],
                    {"transform_type": "affine", "target_shape": (5, 6)},
                    (0,)),
    "grid_warp": ("GridGenerator", [_x(91, (1, 2, 4, 5))],
                  {"transform_type": "warp"}, (0,)),
    "bilinear_sampler": ("BilinearSampler",
                         [_x(92, (2, 3, 5, 6)),
                          _x(93, (2, 2, 4, 5), -1.2, 1.2)], {}, (0, 1)),
    "spatial_transformer": ("SpatialTransformer", [_x(94, (2, 3, 5, 5)),
                                                   THETA],
                            {"target_shape": (4, 4)}, (0, 1)),
    "crop": ("Crop", [_x(95, (1, 2, 8, 8))],
             {"num_args": 1, "offset": (1, 2), "h_w": (4, 5)}, (0,)),
    "crop_center": ("Crop", [_x(95, (1, 2, 8, 8))],
                    {"num_args": 1, "h_w": (4, 4), "center_crop": True},
                    (0,)),
    "crop_like": ("Crop", [_x(96, (1, 2, 7, 8)), _x(97, (1, 2, 3, 3))], {},
                  (0,)),
    "correlation": ("Correlation", [_x(98, (1, 4, 6, 6)),
                                    _x(99, (1, 4, 6, 6))],
                    {"max_displacement": 1}, (0, 1)),
    "correlation_window": ("Correlation", [_x(100, (2, 3, 7, 6)),
                                           _x(101, (2, 3, 7, 6))],
                           {"kernel_size": 3, "max_displacement": 2,
                            "stride1": 2, "stride2": 2, "pad_size": 2},
                           (0, 1)),
    "correlation_absdiff": ("Correlation", [_x(102, (1, 2, 5, 5)),
                                            _x(103, (1, 2, 5, 5))],
                            {"max_displacement": 1, "kernel_size": 2,
                             "is_multiply": False}, (0, 1)),
}

# the samplers: (attrs, parameter arrays of the _sample_* family)
SAMPLERS = {
    "uniform": ({"low": -1.0, "high": 3.0}, ()),
    "normal": ({"loc": 1.0, "scale": 2.0}, ()),
    "random_gamma": ({"alpha": 2.5, "beta": 1.5}, ()),
    "random_exponential": ({"lam": 2.0}, ()),
    "random_poisson": ({"lam": 3.5}, ()),
    "random_negative_binomial": ({"k": 3, "p": 0.4}, ()),
    "random_generalized_negative_binomial": ({"mu": 2.0, "alpha": 0.5}, ()),
    "_sample_uniform": ({}, ([-1.0, 0.0], [1.0, 4.0])),
    "_sample_normal": ({}, ([0.0, 2.0], [1.0, 0.5])),
    "_sample_gamma": ({}, ([1.5, 4.0], [2.0, 0.5])),
    "_sample_exponential": ({}, ([0.5, 3.0],)),
    "_sample_poisson": ({}, ([1.0, 6.0],)),
    "_sample_negative_binomial": ({}, ([2.0, 5.0], [0.3, 0.6])),
    "_sample_generalized_negative_binomial": ({}, ([1.0, 4.0],
                                                   [0.5, 0.2])),
}


# ---------------------------------------------------------------------------
# the port side, on any context
# ---------------------------------------------------------------------------

def heads(shapes, seed):
    """The seeded head gradients of outputs of ``shapes``."""
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randn(*sh), np.float32) for sh in shapes]


def on_own_thread(fn, *args):
    """``fn(*args)`` on a thread of its own.  autograd's marked variables
    are thread-local, so the marks ``fn`` makes end with its thread and
    no later backward meets them."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # re-raised on the caller's thread
            box["err"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def run_port(op, arrays, attrs, grad, ctx, head_seed=0):
    """The port's op on ``ctx`` through its imperative front end:
    ``(outputs, gradients of the inputs grad)`` as numpy, the gradients
    from ``autograd.backward`` of the seeded heads (on a thread of its
    own: its marks end with the case)."""
    import mxnet_tpu_torch as mt

    nd, ag = mt.nd, mt.autograd

    def case():
        with ctx:
            xs = [nd.array(a, dtype=a.dtype) for a in arrays]
            gs = [nd.zeros(arrays[i].shape) for i in grad]
            if grad:
                ag.mark_variables([xs[i] for i in grad], gs)
            with ag.record():
                out = getattr(nd, op)(*xs, **attrs)
                outs = out if isinstance(out, list) else [out]
                if grad:
                    ag.backward(outs, out_grads=[
                        nd.array(h) for h in heads([o.shape for o in outs],
                                                   head_seed)])
            return [o.asnumpy() for o in outs], [g.asnumpy() for g in gs]

    return on_own_thread(case)


def draw_port(op, attrs, params, n, seed, ctx):
    """``n`` draws of a sampler on ``ctx`` after ``random.seed(seed)``:
    (rows, n) numpy, a row for each parameter element."""
    import mxnet_tpu_torch as mt

    with ctx:
        mt.random.seed(seed)
        nd = mt.nd
        args = [nd.array(np.float32(p)) for p in params]
        out = getattr(nd, op)(*args, shape=(n,), **attrs)
        return out.asnumpy().reshape(-1, n)


def case_ops():
    """Every op name a case or a sampler runs."""
    return {c[0] for table in (ELEMWISE, TENSOR, NN, CONTRIB, SPATIAL)
            for c in table.values()} | set(SAMPLERS)
