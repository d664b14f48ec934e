"""Standalone KVStore server bootstrap.

PyTorch counterpart of ``mxnet_tpu/kvstore_server.py`` (reference:
python/mxnet/kvstore_server.py).  Rank 0's ``KVStoreDist`` hosts the
server tier in-process, so a separate server process is needed only for a
dedicated parameter-server host (the workers then name it in
``MXTPU_SERVER_ADDRS``).  As in the reference, a process whose
``MXTPU_ROLE`` (or ``DMLC_ROLE``) is ``server`` becomes that server when
the package is imported: it serves on the coordinator's port until every
worker has sent ``shutdown``, then exits.
"""
from __future__ import annotations

import os

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    """Blocking server runner (reference: kvstore_server.py KVStoreServer)."""

    def __init__(self, kvstore=None):
        from .kvstore_dist import KVStoreDistServer

        coord = os.environ.get("MXTPU_COORDINATOR", "127.0.0.1:9027")
        port = int(coord.rsplit(":", 1)[1])
        num = int(os.environ.get("MXTPU_NUM_PROCS",
                                 os.environ.get("DMLC_NUM_WORKER", "1")))
        self._server = KVStoreDistServer(host="0.0.0.0", port=port,
                                         num_workers=num)

    def run(self):
        """Blocks until all workers sent shutdown."""
        self._server.join()


def _init_kvstore_server_module():
    """Reference entry point: called at import when the role is server."""
    role = os.environ.get("MXTPU_ROLE", os.environ.get("DMLC_ROLE", ""))
    if role == "server":
        server = KVStoreServer()
        server.run()
        raise SystemExit(0)


_init_kvstore_server_module()
