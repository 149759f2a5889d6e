"""The reference's rescoring stages against Sage's definitions, on hand
cases first: Gauss-Jordan with its eps retry, the LDA with constant
feature columns, the KDE posterior error and the q-values. The port's
own functions (``sage_tpu_torch.ml``) serve as a second witness here;
the reference itself imports nothing of the port."""

import numpy as np
import pytest

from benchmark import reference as R


def _solve_port(a, b):
    from sage_tpu_torch.ml import gauss
    return gauss.solve(a, b)


def _spd(rng, n):
    m = rng.normal(size=(n, n))
    return m @ m.T


def test_gauss_well_conditioned_first_eps():
    rng = np.random.default_rng(11)
    a, b = _spd(rng, 6), rng.normal(size=6)
    x, eps = R.gauss_solve(a, b)
    assert eps == 1e-8
    np.testing.assert_allclose(a @ x[:, 0] + 1e-8 * x[:, 0], b, atol=1e-9)
    assert np.array_equal(x, _solve_port(a, b))


def test_gauss_constant_column_is_regularised():
    # a zero row and column (a feature constant in both classes): only the
    # eps on the diagonal keeps the system solvable
    rng = np.random.default_rng(12)
    a = _spd(rng, 5)
    a[2, :] = 0.0
    a[:, 2] = 0.0
    b = rng.normal(size=5)
    b[2] = 3e-15  # the class means' rounding, amplified by 1 / eps
    x, eps = R.gauss_solve(a, b)
    assert eps == 1e-8
    assert x[2, 0] == pytest.approx(3e-15 / 1e-8)
    assert np.array_equal(x, _solve_port(a, b))


@pytest.mark.parametrize("scale,want", [(1e8, 1e-6), (1e10, 1e-5), (1e12, 1e-3)])
def test_gauss_near_singular_goes_past_first_eps(scale, want):
    # two identical features at a large scale: eps = 1e-8 is lost in the
    # rounding of the diagonal, the second pivot comes out 0 and the left
    # side does not reduce; the retry climbs until eps survives
    rng = np.random.default_rng(3)
    a = _spd(rng, 4)
    a[:, 1] = a[:, 0]
    a[1, :] = a[0, :]
    a[:2, :2] *= scale
    b = rng.normal(size=4)
    x, eps = R.gauss_solve(a, b)
    assert eps == pytest.approx(want)
    assert np.array_equal(x, _solve_port(a, b))


def test_gauss_random_cases_match_port():
    rng = np.random.default_rng(13)
    for _ in range(200):
        n = int(rng.integers(2, 9))
        a = _spd(rng, n) * 10.0 ** rng.uniform(-3, 6)
        if rng.random() < 0.3:
            j = int(rng.integers(0, n))
            a[j, :] = a[:, j] = 0.0
        b = rng.normal(size=n)
        x, _ = R.gauss_solve(a, b)
        y = _solve_port(a, b)
        assert (x is None and y is None) or np.array_equal(x, y)


def _table(rng, n, constant=True):
    from sage_tpu_torch.ops.features import FeatureTable

    t = FeatureTable.empty(n)
    c = t.columns
    decoy = rng.random(n) < 0.3
    c["label"][:] = np.where(decoy, -1, 1)
    shift = np.where(decoy, 0.0, 1.0)
    c["rank"][:] = 1
    c["charge"][:] = rng.integers(2, 4, n)
    c["hyperscore"][:] = rng.gamma(4.0, 5.0, n) + 8 * shift
    c["delta_next"][:] = rng.gamma(2.0, 1.0, n) + shift
    c["delta_best"][:] = 0.0
    c["delta_mass"][:] = rng.normal(0, 4, n) * (1.5 - shift)
    c["expmass"][:] = rng.uniform(800, 3000, n)
    c["calcmass"][:] = c["expmass"] - rng.normal(0, 0.01, n)
    c["isotope_error"][:] = 0.0
    c["average_ppm"][:] = rng.uniform(0, 5, n)
    c["poisson"][:] = -rng.gamma(2.0, 3.0, n) - 4 * shift
    c["matched_intensity_pct"][:] = rng.uniform(5, 60, n)
    c["matched_peaks"][:] = rng.integers(4, 30, n)
    c["peptide_len"][:] = rng.integers(7, 30, n)
    c["longest_b"][:] = rng.integers(0, 6, n)
    c["longest_y"][:] = np.minimum(rng.integers(0, 9, n), c["peptide_len"])
    c["missed_cleavages"][:] = rng.integers(0, 3, n)
    c["aligned_rt"][:] = rng.uniform(0, 1, n)
    c["ims"][:] = 0.0
    c["delta_rt_model"][:] = rng.uniform(0, 0.3, n)
    # delta_ims_model stays 0.999 everywhere: sqrt(0.999) is a constant
    # column whose value no f64 sum of n copies hits exactly
    if not constant:
        c["delta_ims_model"][:] = rng.uniform(0, 0.2, n)
    return t


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("constant", [True, False])
def test_lda_matches_port(seed, constant):
    from sage_tpu_torch.chem.mass import Tolerance
    from sage_tpu_torch.ml import lda

    rng = np.random.default_rng(100 + seed)
    t = _table(rng, 3000, constant)
    ours = R.lda_scores(t.columns, ("ppm", -20.0, 20.0))
    assert lda.score_psms(t, Tolerance("ppm", -20.0, 20.0))
    assert ours["eps"] == 1e-8
    np.testing.assert_array_equal(ours["disc"], t.columns["discriminant_score"])
    np.testing.assert_array_equal(ours["pep"], t.columns["posterior_error"])
    # constant columns get rounding noise over eps as their coefficient
    # (rank 1, delta_best 0, isotope_error 0, ims 0, and sqrt(0.999))
    assert ours["coef"][[0, 4, 6, 17]].tolist() == [0.0, 0.0, 0.0, 0.0]
    if constant:
        assert abs(ours["coef"][19]) < 1e-3


def test_kde_and_q_values_match_port():
    from sage_tpu_torch.ml import kde, qvalue

    rng = np.random.default_rng(21)
    s = np.r_[rng.normal(0, 1, 500), rng.normal(3, 1, 1500)]
    d = np.r_[np.ones(500, bool), np.zeros(1500, bool)]
    for mono in (True, False):
        est = kde.build_estimator(s, d, monotonic=mono, bins=1000)
        at = R.kde_pep(s, d, 1000, 1.0, mono)
        np.testing.assert_allclose(at(s), est.posterior_error(s), rtol=1e-12,
                                   atol=1e-15)
    order = np.argsort(-s, kind="stable")
    q, _ = qvalue.spectrum_q_value(np.where(d[order], -1, 1))
    np.testing.assert_array_equal(R.q_values(d[order]), q)


def test_low_precision_control_moves_the_discriminant():
    rng = np.random.default_rng(31)
    t = _table(rng, 3000, True)
    hi = R.lda_scores(t.columns, ("ppm", -20.0, 20.0))
    lo = R.lda_scores(t.columns, ("ppm", -20.0, 20.0), low=True)
    assert np.max(np.abs(hi["disc"] - lo["disc"])) > 1e-3
