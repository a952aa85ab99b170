"""The card's energy over a window: NVML's cumulative energy counter (mJ),
read through ``ctypes`` on ``libnvidia-ml.so.1``, which ships with the
driver (the H100 machines the benchmark ran on all give it). The card's
power limit is read beside it.
"""
from __future__ import annotations

import ctypes
import math
import os


class Meter:
    """Energy between `start` and `stop`, in joules; NaN where the driver
    gives no energy counter."""

    source = "nvml energy counter"

    def __init__(self, index: int | None = None):
        self.handle = ctypes.c_void_p()
        self.lib = None
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return
        lib.nvmlInit_v2.restype = ctypes.c_int
        lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
            ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.nvmlDeviceGetEnforcedPowerLimit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
        for fn in (lib.nvmlDeviceGetHandleByIndex_v2,
                   lib.nvmlDeviceGetTotalEnergyConsumption,
                   lib.nvmlDeviceGetEnforcedPowerLimit):
            fn.restype = ctypes.c_int
        index = nvml_index() if index is None else index
        if lib.nvmlInit_v2() == 0 and lib.nvmlDeviceGetHandleByIndex_v2(
                index, ctypes.byref(self.handle)) == 0:
            self.lib = lib

    def energy_j(self) -> float:
        mj = ctypes.c_ulonglong()
        if self.lib is None or self.lib.nvmlDeviceGetTotalEnergyConsumption(
                self.handle, ctypes.byref(mj)):
            return math.nan
        return mj.value / 1e3

    def power_limit_w(self) -> float:
        mw = ctypes.c_uint()
        if self.lib is None or self.lib.nvmlDeviceGetEnforcedPowerLimit(
                self.handle, ctypes.byref(mw)):
            return math.nan
        return mw.value / 1e3

    def start(self) -> None:
        self._e0 = self.energy_j()

    def stop(self) -> float:
        return self.energy_j() - self._e0


def nvml_index() -> int:
    """The NVML index of CUDA device 0: the first entry of
    CUDA_VISIBLE_DEVICES where that is a number, else 0."""
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    return int(first) if first.strip().isdigit() else 0
