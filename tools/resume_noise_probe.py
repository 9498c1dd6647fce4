#!/usr/bin/env python3
"""Where the LM's kill-and-resume parts from an uninterrupted run
(``chip_smoke.py`` phase 17 (a): the same model, data, seed, Adam and
fence schedule).  Runs four uninterrupted fits (W0-W3), two killed at
RESUME_KILL (K1, K2), two resumes from K1's fence (R1a, and R1b from a
copy of the directory), one from K2's (R2) and one from W0's own fence
(RW0).  Every run waits for the writer at RESUME_FENCE, so that fence is
written.  Prints, for each run, its metric lines and the train step's
perplexity sums and counts after every step (cloned on the stream, keyed
by epoch and batch), then every run's parameter gap to W0 (the sum and
the largest of the per-tensor norms).  Full f32 products.  Run from the
repository root on a machine with one CUDA card::

    python3 tools/resume_noise_probe.py

The JSON goes to stdout and to ``chiprun_out/resume_noise_probe.json``.
"""
import gc
import json
import logging
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as c

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.phase_build()
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import elastic, gpu
    from mxnet_tpu_torch import metric as metric_mod
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.module import Module

    sym = attention_lm.get_symbol(vocab_size=c.VOCAB, seq_len=c.SEQ,
                                  num_layers=c.TRAIN_LAYERS, embed=c.EMBED,
                                  heads=c.TRAIN_HEADS, ffn_hidden=c.FFN)
    params = c._train_params(sym)
    b = c.TRAIN_BATCH
    rng = np.random.RandomState(7)
    X = rng.randint(0, c.VOCAB, size=(c.RESUME_BATCHES * b, c.SEQ)) \
        .astype(np.float32)
    Y = np.concatenate([X[:, 1:], np.zeros((len(X), 1), np.float32)],
                       axis=1)
    base = tempfile.mkdtemp(prefix="resume-noise-")
    out = {"card": c._smi_line(), "runs": {}}
    stores = {}

    def run(name, directory, kill=False):
        mt.random.seed(c.RESUME_SEED)
        lines = c._Lines()
        logger = logging.Logger("probe")
        logger.addHandler(lines)
        mod = Module(sym, context=gpu(0), logger=logger)
        ck = elastic.Checkpointer(directory, period=c.RESUME_PERIOD,
                                  async_write=True)
        inj = elastic.FaultInjector().at_step(c.RESUME_FENCE, ck.wait)
        if kill:
            inj.kill_at(c.RESUME_KILL)
        ctl = elastic.ElasticController(checkpointer=ck, injector=inj)
        acc = []

        def after_step(p):
            state = mod._train_step._metric_acc
            acc.append((p.epoch, p.nbatch,
                        [t.clone() for t in state._tensors()]))

        try:
            mod.fit(mt.io.NDArrayIter(X, Y, batch_size=b),
                    eval_metric=metric_mod.Perplexity(None),
                    num_epoch=c.RESUME_EPOCHS, elastic=ctl,
                    optimizer="adam",
                    optimizer_params={"learning_rate": c.RESUME_LM_LR},
                    arg_params=params, batch_end_callback=after_step)
        except elastic.WorkerKilled:
            pass
        torch.cuda.synchronize()
        out["runs"][name] = {
            "lines": [r for r in lines.rows if "Train-" in r],
            "acc": [(e, n, [float(t) for t in ts]) for e, n, ts in acc],
            "recoveries": ctl.recoveries}
        stores[name] = c._store(mod)
        del mod
        gc.collect()
        torch.cuda.empty_cache()
        print(name, json.dumps(out["runs"][name]), flush=True)

    def d(name):
        return os.path.join(base, name)

    try:
        for i in range(4):
            run("W%d" % i, d("W%d" % i))
        run("K1", d("K1"), kill=True)
        shutil.copytree(d("K1"), d("K1b"))
        run("R1a", d("K1"))
        run("R1b", d("K1b"))
        run("RW0", d("W0"))
        run("K2", d("K2"), kill=True)
        run("R2", d("K2"))
    finally:
        shutil.rmtree(base, ignore_errors=True)

    def gap(x, y):
        g = {k: float(torch.linalg.vector_norm(
            stores[x][k].double() - stores[y][k].double()))
            for k in stores[y] if k.startswith("params/")}
        return {"sum": sum(g.values()), "max": max(g.values()),
                "argmax": max(g, key=g.get)}

    out["gap_vs_W0"] = {n: gap(n, "W0") for n in stores
                        if n != "W0" and not n.startswith("K")}
    out["gap_vs_W0"]["R1a-R1b"] = gap("R1a", "R1b")
    print("gaps", json.dumps(out["gap_vs_W0"]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "resume_noise_probe.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
