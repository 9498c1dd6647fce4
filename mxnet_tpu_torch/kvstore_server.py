"""KVStore server bootstrap (the counterpart of
``mxnet_tpu/kvstore_server.py``).

The reference's cluster scripts start dedicated parameter-server
processes (``DMLC_ROLE=server``).  Here every process is a worker: the
``dist_*`` store all-reduces the gradients across the workers and each
applies the optimizer itself.  The process contract is kept, so those
scripts run unchanged: a process started with ``DMLC_ROLE=server`` logs
why and exits 0 when this module is imported (``import
mxnet_tpu_torch`` imports it), never running the script's body.
"""
from __future__ import annotations

import logging
import os
import sys

__all__ = ["KVStoreServer"]


class KVStoreServer:
    """The reference's server-process API, with nothing to serve."""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.init_logging = False

    def run(self):
        logging.info("mxnet_tpu_torch: the parameter-server role is "
                     "subsumed by the workers' all-reduce; server process "
                     "exiting cleanly")


def _init_kvstore_server_module():
    if os.environ.get("DMLC_ROLE", "") == "server":
        from . import kvstore

        KVStoreServer(kvstore.create("local")).run()
        sys.exit(0)


_init_kvstore_server_module()
