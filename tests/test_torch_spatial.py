"""The port's spatial ops (``mxnet_tpu_torch/ops/spatial.py``) against
the JAX package's, on the CPU: ``ROIPooling``, ``GridGenerator``,
``BilinearSampler``, ``SpatialTransformer``, ``Crop`` and
``Correlation``, forward and gradients (rtol 1e-5 / atol 1e-6, the
cases of ``test_torch_op_cases.SPATIAL`` through
``test_torch_ops_elemwise.run_case``), and the reference tests'
identities through both packages.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from test_torch_op_cases import SPATIAL
from test_torch_ops_elemwise import run_case


@pytest.mark.parametrize("case", sorted(SPATIAL))
def test_spatial_op(case):
    op, arrays, attrs, grad = SPATIAL[case]
    run_case(op, arrays, attrs, grad=grad)


def test_sampler_identities_in_both_packages():
    """Identity transforms reproduce the image, a far-away grid samples
    zeros, and GridGenerator + BilinearSampler equal SpatialTransformer,
    in both packages alike."""
    rng = np.random.RandomState(42)
    data = rng.rand(2, 3, 6, 6).astype(np.float32)
    ident = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1))
    theta = rng.uniform(-0.2, 0.2, (2, 6)).astype(np.float32)
    theta[:, 0] += 1.0
    theta[:, 4] += 1.0
    far = np.full((2, 2, 2, 2), 3.0, np.float32)
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        with ctx:
            nd = pkg.nd
            st = nd.SpatialTransformer(nd.array(data), nd.array(ident),
                                       target_shape=(6, 6)).asnumpy()
            np.testing.assert_allclose(st, data, atol=1e-5)
            warp = nd.BilinearSampler(nd.array(data), nd.GridGenerator(
                nd.zeros((2, 2, 6, 6)), transform_type="warp")).asnumpy()
            np.testing.assert_allclose(warp, data, atol=1e-5)
            out = nd.BilinearSampler(nd.array(data), nd.array(far))
            np.testing.assert_array_equal(out.asnumpy(), 0.0)
            grid = nd.GridGenerator(nd.array(theta), transform_type="affine",
                                    target_shape=(5, 5))
            np.testing.assert_allclose(
                nd.BilinearSampler(nd.array(data), grid).asnumpy(),
                nd.SpatialTransformer(nd.array(data), nd.array(theta),
                                      target_shape=(5, 5)).asnumpy(),
                atol=1e-5)


def test_crop_and_correlation_checks():
    """Crop refuses a window past the input in both packages; the
    correlation of a map with itself at zero displacement is its mean
    square."""
    data = np.random.RandomState(1).rand(1, 4, 6, 6).astype(np.float32)
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        with ctx:
            nd = pkg.nd
            with pytest.raises(Exception):
                nd.Crop(nd.ones((1, 2, 8, 8)), num_args=1, offset=(6, 6),
                        h_w=(4, 4))
            out = nd.Correlation(nd.array(data), nd.array(data),
                                 max_displacement=1).asnumpy()
            np.testing.assert_allclose(out[0, 4], (data[0] ** 2).mean(0),
                                       rtol=1e-5)
