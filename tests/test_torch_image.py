"""RecordIO and the image pipeline through both packages on the CPU
(``mxnet_tpu_torch/recordio.py``, ``_native.py``, ``image.py``).

Records written by either package, with the native codec or the
pure-Python one, are byte for byte the same files and read back in the
other; ``ImageIter``, ``ImageRecordIter`` (also as ``io.ImageRecordIter``)
and ``ImageDetIter`` give the JAX package's batches bit for bit for the
same seed (shuffle, augmenters, ``num_parts``), over two epochs; the
augmenters and the functional geometry match on their own.  Batches are
host arrays in the port.
"""
import filecmp
import importlib.util
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import image as jimage
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _native
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import recordio as trec

# a payload that embeds the magic at aligned offsets: split records
MAGIC = b"\x0a\x23\xd7\xce"
PAYLOADS = [b"", b"abc", b"x" * 4 + MAGIC + b"tail",
            MAGIC + b"1234" + MAGIC, bytes(range(256)) * 3]


def _python_codec(module):
    """The package's MXRecordIO forced onto the pure-Python codec."""
    class PyRecordIO(module.MXRecordIO):
        def __init__(self, uri, flag):
            self.uri = uri
            self.flag = flag
            self.handle = None
            self.is_open = False
            self._lib = None
            self.open()

    return PyRecordIO


def test_native_codec_builds_into_the_port():
    lib = _native.recordio_lib()
    assert lib is not None
    assert os.path.isfile(os.path.join(os.path.dirname(_native.__file__),
                                       "_build", "libmxtorch_io.so"))


@pytest.mark.parametrize("codec", ["native", "python"])
def test_records_are_byte_identical_both_ways(tmp_path, codec):
    """The same records through each package's writer give the same
    bytes; each package reads the other's file back exactly."""
    paths = {}
    for name, module in (("jax", jrec), ("port", trec)):
        cls = module.MXRecordIO if codec == "native" \
            else _python_codec(module)
        path = str(tmp_path / ("%s.rec" % name))
        w = cls(path, "w")
        for p in PAYLOADS:
            w.write(p)
        w.close()
        paths[name] = path
    assert filecmp.cmp(paths["jax"], paths["port"], shallow=False)
    for module, path in ((trec, paths["jax"]), (jrec, paths["port"])):
        cls = module.MXRecordIO if codec == "native" \
            else _python_codec(module)
        r = cls(path, "r")
        assert [r.read() for _ in PAYLOADS] == PAYLOADS
        assert r.read() is None
        r.close()


@pytest.fixture(params=["cv2", "raw"])
def image_codec(request, monkeypatch):
    """Images through OpenCV where it is installed, or through the
    raw-array codec (OpenCV hidden): the path a host without it takes."""
    if request.param == "raw":
        monkeypatch.setitem(sys.modules, "cv2", None)
    elif importlib.util.find_spec("cv2") is None:
        pytest.skip("OpenCV is not installed")
    return request.param


def test_indexed_records_and_image_packing(tmp_path, image_codec):
    """MXIndexedRecordIO files (.rec and .idx), pack / unpack and the
    image codec agree byte for byte; build_index rebuilds the offsets in
    both packages."""
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (5 + i, 7, 3), dtype=np.uint8)
            for i in range(4)]
    files = {}
    for name, module in (("jax", jrec), ("port", trec)):
        idx, rec = str(tmp_path / (name + ".idx")), \
            str(tmp_path / (name + ".rec"))
        w = module.MXIndexedRecordIO(idx, rec, "w")
        for i, img in enumerate(imgs):
            label = [float(i), 0.5] if i % 2 else float(i)
            w.write_idx(i, module.pack_img(module.IRHeader(0, label, i, 7),
                                           img, img_fmt=".png"))
        w.close()
        files[name] = (idx, rec)
    for j, t in zip(files["jax"], files["port"]):
        assert filecmp.cmp(j, t, shallow=False)
    r = trec.MXIndexedRecordIO(*files["jax"], "r")
    for i in (2, 0, 3):
        header, img = trec.unpack_img(r.read_idx(i))
        np.testing.assert_array_equal(img, imgs[i])
        assert (header.id, header.id2) == (i, 7)
    r.close()
    assert trec.build_index(files["port"][1]) == \
        jrec.build_index(files["jax"][1])


def _class_rec(tmp_path, n=11):
    rng = np.random.RandomState(1)
    idx, rec = str(tmp_path / "cls.idx"), str(tmp_path / "cls.rec")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = rng.randint(0, 255, (20 + i % 3, 24, 3), dtype=np.uint8)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i % 4), i, 0),
                                     img, img_fmt=".png"))
    w.close()
    return rec, idx


def _batches(it, epochs=2):
    """Every batch of ``epochs`` epochs as numpy, the iterator reset only
    between them: a prefetching iterator reset mid-stream has run its
    augmenters ahead by as many batches as its worker got to."""
    out = []
    for epoch in range(epochs):
        if epoch:
            it.reset()
        for batch in it:
            assert batch.data[0].context.device_type == "cpu"
            out.append((batch.data[0].asnumpy(), batch.label[0].asnumpy(),
                        batch.pad))
    return out


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.dtype == wd.dtype and gp == wp
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("parts", [(1, 0), (2, 1)])
def test_image_iter_batches_bit_for_bit(tmp_path, parts):
    rec, idx = _class_rec(tmp_path)
    kw = dict(batch_size=3, data_shape=(3, 16, 16), path_imgrec=rec,
              path_imgidx=idx, shuffle=True, rand_crop=True,
              rand_mirror=True, resize=18, brightness=0.3, contrast=0.2,
              saturation=0.2, pca_noise=0.1, mean=np.array([10., 20., 30.]),
              std=np.array([50., 60., 70.]), seed=5, num_parts=parts[0],
              part_index=parts[1])
    got = timage.ImageIter(**kw)
    want = jimage.ImageIter(**kw)
    _same_batches(_batches(got), _batches(want))
    got.close()
    want.close()


def test_image_record_iter_batches_bit_for_bit(tmp_path):
    rec, idx = _class_rec(tmp_path)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 12, 12),
              batch_size=4, shuffle=True, rand_crop=True, rand_mirror=True,
              mean_r=5, mean_g=6, mean_b=7, std_r=2, seed=3)
    got = mt.io.ImageRecordIter(**kw)
    want = mx.io.ImageRecordIter(**kw)
    try:
        _same_batches(_batches(got), _batches(want))
    finally:
        got.close()
        want.close()


def _det_rec(tmp_path, n=10):
    rng = np.random.RandomState(2)
    idx, rec = str(tmp_path / "det.idx"), str(tmp_path / "det.rec")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = rng.randint(0, 255, (30, 28, 3), dtype=np.uint8)
        objs = []
        for _ in range(rng.randint(1, 4)):
            x0, y0 = rng.uniform(0, 0.5, 2)
            objs.append([rng.randint(0, 3), x0, y0,
                         min(x0 + rng.uniform(0.2, 0.5), 1),
                         min(y0 + rng.uniform(0.2, 0.5), 1)])
        label = np.concatenate([[2, 5], np.ravel(objs)]).astype(np.float32)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, label, i, 0), img,
                                     img_fmt=".png"))
    w.close()
    return rec, idx


@pytest.mark.parametrize("parts", [(1, 0), (2, 0)])
def test_image_det_iter_batches_bit_for_bit(tmp_path, parts, image_codec):
    rec, idx = _det_rec(tmp_path)
    kw = dict(batch_size=4, data_shape=(3, 20, 20), path_imgrec=rec,
              path_imgidx=idx, shuffle=True, rand_crop=0.7, rand_pad=0.5,
              rand_mirror=True, mean=np.array([1., 2., 3.]),
              std=np.array([4., 5., 6.]), seed=9, num_parts=parts[0],
              part_index=parts[1])
    if parts[0] > 1:
        kw["label_pad_width"] = 4
    got = timage.ImageDetIter(**kw)
    want = jimage.ImageDetIter(**kw)
    assert got.provide_label[0].shape == want.provide_label[0].shape
    _same_batches(_batches(got), _batches(want))
    got.close()
    want.close()


def test_det_record_iter_and_ssd_dataset(tmp_path, image_codec):
    """ImageDetRecordIter, and the SSD example's data: ``models.ssd.
    make_dataset`` writes the example's records byte for byte."""
    prefix = str(tmp_path / "shapes")
    mt.models.ssd.make_dataset(prefix, n=12)
    import examples.ssd_detection as example

    example.make_dataset(str(tmp_path / "ref"), n=12)
    for ext in (".rec", ".idx"):
        assert filecmp.cmp(prefix + ext, str(tmp_path / "ref") + ext,
                           shallow=False)
    kw = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
              data_shape=(3, 32, 32), batch_size=5, shuffle=True,
              rand_mirror=True, label_name="label", seed=0)
    got = timage.ImageDetRecordIter(**kw)
    want = jimage.ImageDetRecordIter(**kw)
    try:
        _same_batches(_batches(got), _batches(want))
    finally:
        got.close()
        want.close()


def test_augmenters_and_geometry():
    """Each augmenter and helper, seeded alike, on the same image."""
    img = np.random.RandomState(4).randint(0, 255, (21, 17, 3)) \
        .astype(np.uint8)
    assert timage.scale_down((17, 21), (20, 30)) == \
        jimage.scale_down((17, 21), (20, 30))
    np.testing.assert_array_equal(timage.resize_short(img, 9),
                                  jimage.resize_short(img, 9))
    for name in ("random_crop", "random_size_crop"):
        args = ((img, (8, 10)) if name == "random_crop"
                else (img, (8, 10), 0.3, (0.75, 1.33)))
        g, gw = getattr(timage, name)(*args, rng=np.random.default_rng(1))
        w, ww = getattr(jimage, name)(*args, rng=np.random.default_rng(1))
        np.testing.assert_array_equal(g, w)
        assert gw == ww
    chain = dict(data_shape=(3, 10, 10), resize=12, rand_crop=True,
                 rand_resize=True, rand_mirror=True, mean=True, std=True,
                 brightness=0.4, contrast=0.4, saturation=0.4,
                 pca_noise=0.2, seed=11)
    det = dict(data_shape=(3, 10, 10), resize=14, rand_crop=1.0,
               rand_pad=1.0, rand_mirror=True, mean=[1., 2., 3.], seed=12)
    boxes = np.array([[1, 0.1, 0.2, 0.6, 0.7], [2, 0.3, 0.3, 0.9, 0.8]],
                     np.float32)
    for _ in range(3):
        g = w = img
        for ga, wa in zip(timage.CreateAugmenter(**chain),
                          jimage.CreateAugmenter(**chain)):
            g, w = ga(g), wa(w)
        np.testing.assert_array_equal(g, w)
        g, gb = img, boxes
        w, wb = img, boxes
        for ga, wa in zip(timage.CreateDetAugmenter(**det),
                          jimage.CreateDetAugmenter(**det)):
            g, gb = ga(g, gb)
            w, wb = wa(w, wb)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(gb, wb)
