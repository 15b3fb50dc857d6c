"""The card's energy, read through NVML by ``ctypes`` on
``libnvidia-ml.so.1``: the total-energy counter (mJ since the driver
loaded) where the card has one, else its power (mW) sampled by a thread
at 20 Hz and integrated."""
from __future__ import annotations

import ctypes
import threading
import time
from typing import Optional

NVML_SUCCESS = 0


class _Nvml:
    def __init__(self) -> None:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        self.lib = lib
        lib.nvmlInit_v2.restype = ctypes.c_int
        lib.nvmlInit_v2.argtypes = []
        lib.nvmlShutdown.restype = ctypes.c_int
        lib.nvmlShutdown.argtypes = []
        lib.nvmlDeviceGetHandleByUUID.restype = ctypes.c_int
        lib.nvmlDeviceGetHandleByUUID.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetHandleByIndex_v2.restype = ctypes.c_int
        lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
            ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetTotalEnergyConsumption.restype = ctypes.c_int
        lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.nvmlDeviceGetPowerUsage.restype = ctypes.c_int
        lib.nvmlDeviceGetPowerUsage.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
        lib.nvmlDeviceGetEnforcedPowerLimit.restype = ctypes.c_int
        lib.nvmlDeviceGetEnforcedPowerLimit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
        if lib.nvmlInit_v2() != NVML_SUCCESS:
            raise OSError("nvmlInit failed")

    def handle(self, uuid: Optional[str], index: int) -> ctypes.c_void_p:
        h = ctypes.c_void_p()
        if uuid and self.lib.nvmlDeviceGetHandleByUUID(
                uuid.encode(), ctypes.byref(h)) == NVML_SUCCESS:
            return h
        if self.lib.nvmlDeviceGetHandleByIndex_v2(
                index, ctypes.byref(h)) != NVML_SUCCESS:
            raise OSError("no NVML handle for the card")
        return h


class EnergyMeter:
    """Joules of one card between :meth:`start` and :meth:`stop`.
    ``source`` says how they were read: "nvml_energy_counter",
    "nvml_power_samples", or None where neither could be read."""

    def __init__(self, uuid: Optional[str] = None, index: int = 0):
        self.source: Optional[str] = None
        self.power_limit_w: Optional[float] = None
        self._nvml = None
        self._samples = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        try:
            self._nvml = _Nvml()
            self._h = self._nvml.handle(uuid, index)
        except OSError:
            self._nvml = None
            return
        mw = ctypes.c_uint()
        if self._nvml.lib.nvmlDeviceGetEnforcedPowerLimit(
                self._h, ctypes.byref(mw)) == NVML_SUCCESS:
            self.power_limit_w = mw.value / 1e3
        if self._energy_mj() is not None:
            self.source = "nvml_energy_counter"
        elif self._power_mw() is not None:
            self.source = "nvml_power_samples"

    def _energy_mj(self) -> Optional[int]:
        v = ctypes.c_ulonglong()
        if self._nvml.lib.nvmlDeviceGetTotalEnergyConsumption(
                self._h, ctypes.byref(v)) != NVML_SUCCESS:
            return None
        return int(v.value)

    def _power_mw(self) -> Optional[int]:
        v = ctypes.c_uint()
        if self._nvml.lib.nvmlDeviceGetPowerUsage(
                self._h, ctypes.byref(v)) != NVML_SUCCESS:
            return None
        return int(v.value)

    def _sample(self) -> None:
        while not self._stop.is_set():
            self._samples.append((time.perf_counter(), self._power_mw()))
            self._stop.wait(0.05)

    def start(self) -> None:
        if self.source == "nvml_energy_counter":
            self._e0 = self._energy_mj()
        elif self.source == "nvml_power_samples":
            self._samples = []
            self._stop.clear()
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()

    def stop(self) -> Optional[float]:
        """Joules since :meth:`start`, or None when not readable."""
        if self.source == "nvml_energy_counter":
            return (self._energy_mj() - self._e0) / 1e3
        if self.source == "nvml_power_samples":
            self._stop.set()
            self._thread.join(timeout=5.0)
            pts = [(t, p) for t, p in self._samples if p is not None]
            return sum((t1 - t0) * (p0 + p1) / 2e3
                       for (t0, p0), (t1, p1) in zip(pts, pts[1:]))
        return None

    def close(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            self._thread.join(timeout=5.0)
        if self._nvml is not None:
            self._nvml.lib.nvmlShutdown()
            self._nvml = None
