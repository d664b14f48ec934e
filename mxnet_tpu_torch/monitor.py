"""Monitor: statistics of an executor's outputs, for debugging.

PyTorch counterpart of ``mxnet_tpu/monitor.py`` (reference:
python/mxnet/monitor.py).  ``install`` hooks ``stat_helper`` into the
executor's ``set_monitor_callback`` (called with each output after a
forward); ``tic`` opens a step every ``interval`` calls, ``toc`` adds the
installed executors' current outputs and returns the step's
``(step, name, stat)`` rows (host numpy values: the stat function runs on
the host).
"""
from __future__ import annotations

import logging
import re

import numpy as _np

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                return _np.abs(x).mean()

        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_pattern = re.compile(pattern)
        self.sort = sort

    def stat_helper(self, name, array):
        if not self.activated or not self.re_pattern.match(name):
            return
        arr = array.asnumpy() if isinstance(array, NDArray) \
            else _np.asarray(array)
        self.queue.append((self.step, name, self.stat_func(arr)))

    def install(self, exe, monitor_all=False):
        exe.set_monitor_callback(self.stat_helper, monitor_all)
        self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        # the outputs' rows go in before deactivating: stat_helper does
        # nothing once inactive
        for exe in self.exes:
            for name, array in zip(exe._out_names, exe.outputs):
                self.stat_helper(name, array)
        self.activated = False
        res = self.queue
        self.queue = []
        if self.sort:
            res.sort(key=lambda x: x[1])
        return res

    def toc_print(self):
        for n, k, v_list in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, str(v_list))
