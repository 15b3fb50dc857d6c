"""The energy meter where NVML cannot be read (this machine has no
card), and the integration of sampled power."""
from clover_bench import energy


def test_no_nvml_reads_nothing():
    m = energy.EnergyMeter()
    if m.source is not None:                 # a card is present
        m.close()
        return
    m.start()
    assert m.stop() is None
    m.close()


def test_power_samples_integrate_by_trapezoids():
    m = energy.EnergyMeter.__new__(energy.EnergyMeter)
    m.source = "nvml_power_samples"
    m._samples = [(0.0, 100000), (0.5, 300000), (1.0, 300000)]

    class _T:
        def join(self, timeout):
            pass
    m._thread = _T()
    m._stop = __import__("threading").Event()
    # (0.5 s x 200 W) + (0.5 s x 300 W) = 250 J
    assert abs(m.stop() - 250.0) < 1e-9
