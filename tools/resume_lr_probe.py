#!/usr/bin/env python3
"""Run the card test's AlexNet kill-and-resume fit
(``tests/test_torch_cuda.py::test_fit_killed_and_resumed_on_the_card_bitwise``)
at several SGD learning rates and print, for each, how many of the
store's tensors are not finite in the uninterrupted and the resumed run,
how many differ under ``torch.equal`` (a NaN is unequal to itself), and
which differ once NaNs are masked (the same NaN positions, the other
values equal bit for bit).  Full f32 products, cuDNN's deterministic
algorithms.  Run from the repository root on a machine with one CUDA
card::

    python3 tools/resume_lr_probe.py --lr 0.1 0.01
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _alexnet_case(mt):
    with mt.NameManager():
        sym = mt.models.get_alexnet(num_classes=10)
    shape = (16, 3, 67, 67)
    arg_shapes, _, _ = sym.infer_shape(data=(4,) + shape[1:],
                                       softmax_label=(4,))
    rng = np.random.RandomState(0)
    args = {n: (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
                if n.endswith("_weight") else np.zeros(s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    X = rng.uniform(-1, 1, shape).astype(np.float32)
    Y = rng.randint(0, 10, 16).astype(np.float32)
    return sym, args, X, Y


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[0.1, 0.01])
    lrs = ap.parse_args().lr
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    import mxnet_tpu_torch as mt
    import test_torch_cuda as t
    from mxnet_tpu_torch import checkpoint

    card = torch.device("cuda", 0)
    sym, args, X, Y = _alexnet_case(mt)

    def nonfinite(store):
        return [k for k, v in store.items() if not bool(torch.isfinite(v).all())]

    def nan_masked_equal(a, b):
        return (torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a, nan=0.0),
                                torch.nan_to_num(b, nan=0.0)))

    out = {}
    for lr in lrs:
        with tempfile.TemporaryDirectory() as root:
            whole, line, _ = t._resume_fit(card, sym, args, {}, X, Y,
                                           os.path.join(root, "w"), lr=lr)
            kdir = os.path.join(root, "k")
            t._resume_fit(card, sym, args, {}, X, Y, kdir, kill=True, lr=lr)
            fence = checkpoint.latest_step(kdir)
            resumed, rline, _ = t._resume_fit(card, sym, args, {}, X, Y,
                                              kdir, lr=lr)
        out[str(lr)] = {
            "fence": fence, "lines": [line, rline], "tensors": len(whole),
            "whole_nonfinite": len(nonfinite(whole)),
            "resumed_nonfinite": len(nonfinite(resumed)),
            "whole_nan_elems": sum(int(torch.isnan(v).sum())
                                   for v in whole.values()),
            "whole_inf_elems": sum(int(torch.isinf(v).sum())
                                   for v in whole.values()),
            "unequal_torch_equal": sum(not torch.equal(whole[k], resumed[k])
                                       for k in whole),
            "unequal_nan_masked": [k for k in whole if not nan_masked_equal(
                whole[k], resumed[k])]}
    print("resume_lr_probe:", json.dumps(out))


if __name__ == "__main__":
    main()
