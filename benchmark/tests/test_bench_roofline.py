"""The narrow search's work count against hand counts, and its
independence of how the inputs are laid out."""

import numpy as np

from benchmark import roofline
from benchmark.traffic import Spectrum


class _Cands:
    """Three target masses of known lengths (decoys double them)."""

    def __init__(self):
        self.mass = np.array([1000.0, 1000.01, 1500.0])
        lens = np.array([10, 12, 8])
        self.slot_sum = np.r_[0, np.cumsum(2 * np.maximum(lens - 3, 0))]
        self.full_sum = np.r_[0, np.cumsum(2 * (lens - 1))]


def _spec(mass, z, peaks):
    mz = np.r_[np.sort(np.random.default_rng(0).uniform(200, 900, peaks))]
    prec = (mass + z * 1.0072764) / z
    return Spectrum(id="s", rt=0.0, prec_mz=prec, charge=z, mz=mz,
                    intensity=np.ones(peaks, np.float32), truth=None, shift=0.0)


def _finite(s):
    return int(np.isfinite(s.mz).sum())


def test_hand_count():
    c = _Cands()
    s = _spec(1000.005, 3, 40)  # +-20 ppm holds the first two masses
    w = roofline.narrow_work(c, [s], ("ppm", -20.0, 20.0), None, _finite)
    slots = 2 * ((10 - 3) * 2 + (12 - 3) * 2)  # targets and decoys
    n_c = 4
    assert w["ops"] == slots * 2 + n_c * 40  # two fragment charges at z 3
    rows = 2 * 4 * (2 * 9 + 2 * 11)
    assert w["bytes"] == 8 * 40 + 64 + rows


def test_padding_does_not_count():
    c = _Cands()
    s = _spec(1500.0, 2, 30)
    padded = Spectrum(**{**s.__dict__,
                         "mz": np.r_[s.mz, np.full(98, np.inf)],
                         "intensity": np.r_[s.intensity, np.zeros(98, np.float32)]})
    a = roofline.narrow_work(c, [s], ("ppm", -20.0, 20.0), None, _finite)
    b = roofline.narrow_work(c, [padded], ("ppm", -20.0, 20.0), None, _finite)
    assert a == b


def test_shared_rows_read_once():
    c = _Cands()
    s = _spec(1000.005, 2, 10)
    one = roofline.narrow_work(c, [s], ("ppm", -20.0, 20.0), None, _finite)
    two = roofline.narrow_work(c, [s, s], ("ppm", -20.0, 20.0), None, _finite)
    rows = 2 * 4 * (2 * 9 + 2 * 11)
    assert two["ops"] == 2 * one["ops"]
    assert two["bytes"] == 2 * (one["bytes"] - rows) + rows


def test_isotope_windows_hand_count():
    """Each searched isotope error opens a window at the precursor mass
    less that many neutrons: a precursor read one isotope heavy counts
    the candidates of its monoisotopic window, and windows that both
    hold candidates add up."""
    c = _Cands()
    iso = float(roofline.NEUTRON)
    heavy = _spec(1000.005 + iso, 3, 40)
    mono = _spec(1000.005, 3, 40)
    want = roofline.narrow_work(c, [mono], ("ppm", -20.0, 20.0), None, _finite)
    for isotopes in ((0, 1), range(-1, 4)):
        got = roofline.narrow_work(c, [heavy], ("ppm", -20.0, 20.0), None,
                                   _finite, isotopes)
        assert got == want
    assert roofline.narrow_work(c, [heavy], ("ppm", -20.0, 20.0), None,
                                _finite)["ops"] == 0

    class Two(_Cands):
        def __init__(self):
            super().__init__()
            self.mass = np.array([1000.0, 1000.0 + iso, 1500.0])

    s = _spec(1000.0 + iso, 2, 10)
    both = roofline.narrow_work(Two(), [s], ("ppm", -20.0, 20.0), None,
                                _finite, (0, 1))
    slots = 2 * ((10 - 3) * 2 + (12 - 3) * 2)
    assert both["ops"] == slots * 1 + 4 * 10
    assert both["bytes"] == 8 * 10 + 64 + 2 * 4 * (2 * 9 + 2 * 11)
