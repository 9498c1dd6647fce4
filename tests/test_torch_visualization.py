"""``mxnet_tpu_torch.visualization`` (``viz``) and
``mxnet_tpu_torch.contrib.tensorboard`` against the JAX package's.

* ``print_summary``'s text and ``plot_network``'s dot source are equal
  to the JAX package's for ``tests/test_visualization.py``'s nets (an
  MLP with and without shapes, a two-branch sum) and for
  ``attention_lm`` (names pinned with ``NameManager`` in both);
* ``LogMetricsCallback`` writes the same scalars (tags, steps, values)
  as the JAX package's, read back with tensorboard's event reader.
  TensorFlow, which this host also has, is hidden while the writer and
  the reader are first imported: tensorboard then takes its own stub
  (as on a host without TensorFlow), and the import costs a second
  rather than about fifteen.
"""
import glob
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models import attention_lm as jax_lm

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import attention_lm

PKGS = {"jax": mx, "port": mt}


def _mlp(p):
    with p.NameManager():
        data = p.sym.Variable("data")
        net = p.sym.FullyConnected(data, num_hidden=10, name="fc1")
        net = p.sym.Activation(net, act_type="relu", name="relu1")
        net = p.sym.FullyConnected(net, num_hidden=5, name="fc2")
        return p.sym.SoftmaxOutput(net, name="softmax")


def _branches(p):
    with p.NameManager():
        a = p.sym.Variable("data")
        b = p.sym.FullyConnected(a, num_hidden=4, name="fca")
        c = p.sym.FullyConnected(a, num_hidden=4, name="fcb")
        return b + c


def _lm(p):
    build = jax_lm.get_symbol if p is mx else attention_lm.get_symbol
    with p.NameManager():
        return build(32, 16, num_layers=2, embed=16, heads=2,
                     ffn_hidden=32)


NETS = {"mlp": (_mlp, {"data": (8, 20)}), "mlp_no_shape": (_mlp, None),
        "branches": (_branches, {"data": (2, 4)}),
        "attention_lm": (_lm, {"data": (2, 16), "softmax_label": (2, 16)})}


@pytest.mark.parametrize("net", sorted(NETS))
def test_print_summary_matches_jax(net, capsys):
    build, shape = NETS[net]
    out = {}
    for k, p in PKGS.items():
        p.visualization.print_summary(build(p), shape=shape)
        out[k] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert "Total params:" in out["port"]
    if net == "mlp":
        assert "Total params: 265" in out["port"]
    assert mt.viz is mt.visualization


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("hide_weights", [True, False])
def test_plot_network_matches_jax(net, hide_weights):
    build, shape = NETS[net]
    src = {k: p.viz.plot_network(build(p), title=net, shape=shape,
                                 hide_weights=hide_weights).source
           for k, p in PKGS.items()}
    assert src["port"] == src["jax"]
    assert src["port"].startswith("digraph %s {" % net)


def test_print_summary_rejects_non_symbol():
    with pytest.raises(TypeError):
        mt.viz.print_summary("not a symbol")


def _scalars(logdir):
    from tensorboard.backend.event_processing import event_accumulator

    files = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    assert len(files) == 1, files
    acc = event_accumulator.EventAccumulator(files[0])
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


@pytest.fixture
def _no_tensorflow(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)


@pytest.mark.usefixtures("_no_tensorflow")
@pytest.mark.parametrize("prefix", [None, "train"])
def test_log_metrics_callback_writes_the_jax_scalars(tmp_path, prefix):
    """Two batches of an accuracy and a cross-entropy metric, and one
    call without a metric (skipped), through each package's callback."""
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 3, size=6).astype(np.float32),
                rng.dirichlet(np.ones(3), size=6).astype(np.float32))
               for _ in range(2)]
    got = {}
    for k, p in PKGS.items():
        logdir = str(tmp_path / k)
        cb = p.contrib.tensorboard.LogMetricsCallback(logdir, prefix=prefix)
        with mt.cpu():
            metric = p.metric.create(["acc", "ce"])
            for label, pred in batches:
                metric.update([p.nd.array(label)], [p.nd.array(pred)])
                cb(p.mod.BatchEndParam(0, 0, metric, {}))
        cb(p.mod.BatchEndParam(0, 0, None, {}))
        cb.summary_writer.close()
        got[k] = _scalars(logdir)
    assert got["port"].keys() == got["jax"].keys()
    assert len(got["port"]) == 2
    for tag, events in got["jax"].items():
        assert [s for s, _ in got["port"][tag]] == [s for s, _ in events] \
            == [1, 2]
        np.testing.assert_allclose([v for _, v in got["port"][tag]],
                                   [v for _, v in events], rtol=1e-6)
        assert tag.startswith("%s-" % prefix) == (prefix is not None)
