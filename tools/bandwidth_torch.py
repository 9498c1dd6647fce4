#!/usr/bin/env python3
"""Communication bandwidth probe for the PyTorch port (the counterpart of
``tools/bandwidth.py``): what moves bytes in the port's data
parallelism.

* host -> device copies (pinned host memory to the card), when there is
  a card;
* ``all_reduce(SUM)`` over the process group (the ``dist_*`` KVStore's
  one collective a push);
* ``broadcast`` from rank 0 over the same group.

Bus bandwidth follows the usual ring accounting: an all-reduce of B
bytes over W ranks moves ``2 (W - 1) / W x B`` a rank, a broadcast
``B``.  At a world of one both are the backend's local copy.

Run one process a rank, the group formed by ``parallel.launch.init``
from the DMLC_* or torchrun variables::

    python tools/bandwidth_torch.py [--sizes 1,16,64,256] [--backend gloo]

``--backend gloo`` serves ranks that share one card.  ``--smoke`` forms
a world of one on gloo (127.0.0.1, a free port), runs tiny sizes on the
CPU and prints one JSON line: the test of the tool.
"""
import argparse
import json
import os
import socket
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seconds(fn, device, iters):
    fn()                                    # warm: buffers, connections
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def measure(sizes_mb, device, iters=5):
    """One row a size: ``{"mib", "bytes", "h2d_gbps", "all_reduce_s",
    "all_reduce_busbw_gbps", "broadcast_s", "broadcast_gbps"}`` over the
    current process group (f32 tensors on ``device``; ``h2d_gbps`` None
    without a card).  Every rank must call it with the same sizes."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    rows = []
    for mb in sizes_mb:
        n = max(1, int(mb * 2 ** 20 / 4))
        nbytes = n * 4
        x = torch.ones(n, dtype=torch.float32, device=device)
        h2d = None
        if device.type == "cuda":
            host = torch.ones(n, dtype=torch.float32).pin_memory()
            t = _seconds(lambda: x.copy_(host, non_blocking=True), device,
                         iters)
            h2d = nbytes / t / 1e9
        ar = _seconds(lambda: dist.all_reduce(x), device, iters)
        bc = _seconds(lambda: dist.broadcast(x, 0), device, iters)
        rows.append({"mib": mb, "bytes": nbytes, "h2d_gbps": h2d,
                     "all_reduce_s": ar,
                     "all_reduce_busbw_gbps":
                         2.0 * (world - 1) / world * nbytes / ar / 1e9
                         if world > 1 else nbytes / ar / 1e9,
                     "broadcast_s": bc, "broadcast_gbps": nbytes / bc / 1e9})
    return rows


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,16,64,256",
                    help="payload sizes in MiB")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl with a card)")
    ap.add_argument("--smoke", action="store_true",
                    help="a world of one on gloo, tiny sizes, one JSON line")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from mxnet_tpu_torch.parallel import launch

    if args.smoke:
        launch.init("127.0.0.1:%d" % _free_port(), 1, 0, backend="gloo")
        sizes, iters, device = "0.25,1", 2, torch.device("cpu")
    else:
        launch.init(backend=args.backend)
        sizes, iters = args.sizes, 5
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    if not dist.is_initialized():
        raise SystemExit("bandwidth_torch: no process group (set the "
                         "DMLC_* or torchrun variables)")
    try:
        rows = measure([float(s) for s in sizes.split(",")], device, iters)
        report = {"backend": dist.get_backend(),
                  "world": dist.get_world_size(), "rank": dist.get_rank(),
                  "device": str(device), "rows": rows}
        if not args.smoke:
            for r in rows:
                print("%8.2f MiB | h2d %s | all-reduce %.6f s (%.2f GB/s bus)"
                      " | broadcast %.6f s (%.2f GB/s)"
                      % (r["mib"], "-" if r["h2d_gbps"] is None
                         else "%.2f GB/s" % r["h2d_gbps"], r["all_reduce_s"],
                         r["all_reduce_busbw_gbps"], r["broadcast_s"],
                         r["broadcast_gbps"]), flush=True)
        print(json.dumps(report), flush=True)
    finally:
        launch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
