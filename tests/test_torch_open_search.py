"""The PyTorch port's open search (-500/+100 Da) against sage_tpu on the
CPU.

The same FASTA text and the same spectra (numpy arrays from a seed) go
through ``sage_tpu`` (JAX on the CPU) and ``sage_tpu_torch`` (the plain
PyTorch versions on the CPU): the device range probes equal the host's
searchsorted ranges, the count core's packed output equals the JAX
package's, and every FeatureTable column of ``score_table`` and
``score_stream`` equals sage_tpu's, element for element, with no
tolerance. ``SAGE_TPU_OPEN_THRESHOLD=1`` sends these small windows
(under 8192 candidates) through the open path."""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sage_tpu.chem.fasta as jfasta
import sage_tpu.chem.mass as jmass
import sage_tpu.index.builder as jbuilder
import sage_tpu.ops.open_search as jopen
import sage_tpu.ops.search as jsearch
import sage_tpu.spectrum.processor as jproc
import sage_tpu_torch.chem.fasta as tfasta
import sage_tpu_torch.chem.mass as tmass
import sage_tpu_torch.index.builder as tbuilder
import sage_tpu_torch.ops.open_search as topen
import sage_tpu_torch.ops.search as tsearch
import sage_tpu_torch.spectrum.processor as tproc
import _peak_cases as pc
from test_torch_search import _build, _params, _spectra, assert_tables_equal

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
OPEN = ("da", -500.0, 100.0)
FRAG = ("ppm", -15.0, 15.0)


def _fasta(n_proteins, length=240, seed=3):
    rng = np.random.default_rng(seed)
    return "\n".join(
        f">sp|OPEN{i:04d}|OPEN{i}_SYN synthetic\n"
        + AA[rng.integers(0, len(AA), size=length)].tobytes().decode()
        for i in range(n_proteins)
    )


@pytest.fixture(scope="module")
def dbs():
    text = _fasta(40)
    return _build(jfasta, jbuilder, text), _build(tfasta, tbuilder, text)


def _arrays(db, n, seed, charge=2, shift=80.0):
    """Spectra from real b/y ladders plus noise, the precursor shifted by
    a random "modification" inside the open window."""
    rng = np.random.default_rng(seed)
    b, y = db.table.ladders()
    targets = np.flatnonzero(db.table.lens >= 7)
    out = []
    for _ in range(n):
        p = int(rng.choice(targets))
        k = int(db.table.lens[p]) - 1
        frags = np.concatenate([b[p, :k], y[p, :k]])
        take = frags[rng.random(frags.shape[0]) < 0.8]
        noise = rng.uniform(200.0, 2000.0, size=25).astype(np.float32)
        masses = np.sort(np.concatenate([take, noise]).astype(np.float32))
        intens = rng.uniform(1.0, 1e5, masses.size).astype(np.float32)
        mono = float(db.table.mono[p]) + float(rng.uniform(-shift, shift))
        out.append({"masses": masses, "intens": intens, "charge": charge,
                    "mz": mono / 2 + float(jmass.PROTON)})
    return out


def _scorers(dbs, prec=OPEN, frag=FRAG, **kw):
    jdb, tdb = dbs
    return (jsearch.Scorer(jdb, _params(jsearch, jmass, prec, frag, **kw)),
            tsearch.Scorer(tdb, _params(tsearch, tmass, prec, frag, **kw),
                           device="cpu"))


def _searchers(dbs, nb, monkeypatch, Z=2, frag=FRAG, prec=OPEN):
    jdb, tdb = dbs
    monkeypatch.setenv("SAGE_TPU_OPEN_BANDS", str(nb))
    return (
        jopen.OpenSearcher(jdb, jmass.Tolerance(*frag), Z, K=50,
                           precursor_tol=jmass.Tolerance(*prec)),
        topen.OpenSearcher(tdb, tmass.Tolerance(*frag), Z, K=50,
                           precursor_tol=tmass.Tolerance(*prec),
                           device="cpu"),
    )


def _batch_inputs(dbs, arrays, Zb=1, prec=OPEN):
    """Padded peaks, query rows and the window union of one batch, from
    the port's own Scorer (host numpy)."""
    _js, ts = _scorers(dbs, prec=prec)
    spectra = _spectra(tproc, arrays)
    masses, intens, Pk = ts._pad_peaks(spectra)
    rows = ts._expand_rows(spectra)
    u0, u1 = topen.spectrum_window_union(rows, len(spectra))
    return masses, intens, rows, u0, u1


@pytest.mark.parametrize("form", ["grid", "slots"])
@pytest.mark.parametrize("nb", [1, 4, 16])
def test_device_ranges_match_host(dbs, monkeypatch, nb, form):
    """The three-level decimated rank probe gives exactly the ranges of
    sage_tpu's host searchsorted ``ranges()`` (padding peaks, duplicate
    masses and window edges included), in the grid and the slot-major
    forms, for Zb = 1 and 2; the port's host ranges equal them too."""
    jos, tos = _searchers(dbs, nb, monkeypatch)
    assert tos.n_bands == jos.n_bands == nb
    masses, intens, rows, u0, u1 = _batch_inputs(dbs, _arrays(dbs[0], 24, 7))
    B, Pk = masses.shape
    peaks = torch.from_numpy(np.stack([masses, intens]))
    for Zb in (1, 2):
        h_st, h_ln = jos.ranges(masses, Zb, u0, u1)
        assert h_ln.sum() > 0
        p_st, p_ln = tos.ranges(masses, Zb, u0, u1)
        np.testing.assert_array_equal(p_st, h_st)
        np.testing.assert_array_equal(p_ln, h_ln)
        b0, b1, nbcov = topen.covered_bands(u0, u1, tos.band_w, nb, B)
        if form == "grid":
            d_st, d_ln, d_nbcov = tos.ranges_device(peaks, u0, u1, Zb)
            assert d_nbcov == nbcov
            np.testing.assert_array_equal(d_st.numpy(), h_st)
            np.testing.assert_array_equal(d_ln.numpy(), h_ln)
            continue
        # every (spectrum, covered-band slot) pair, some of them invalid
        s_arr = np.repeat(np.arange(B), nbcov)
        k_arr = np.tile(np.arange(nbcov), B)
        valid = k_arr <= (b1 - b0)[s_arr]
        band = np.clip(b0[s_arr] + k_arr, 0, nb - 1)
        d_st, d_ln = tos.ranges_device_slots(peaks, s_arr, band, valid, Zb)
        d_st = d_st.numpy().reshape(-1, Zb, Pk)
        d_ln = d_ln.numpy().reshape(-1, Zb, Pk)
        h_st = h_st.reshape(B, Zb, nbcov, Pk)[s_arr, :, k_arr]
        h_ln = h_ln.reshape(B, Zb, nbcov, Pk)[s_arr, :, k_arr]
        np.testing.assert_array_equal(d_st[valid], h_st[valid])
        np.testing.assert_array_equal(d_ln[valid], h_ln[valid])
        assert not d_st[~valid].any() and not d_ln[~valid].any()
        assert nb == 1 or (~valid).any()


@pytest.mark.parametrize("nbcov_gt1", [False, True], ids=["nbcov1", "nbcovN"])
@pytest.mark.parametrize("Z", [1, 2])
@pytest.mark.parametrize("chunked", [False, True], ids=["flat", "chunked"])
def test_device_open_count_matches_sage_tpu(dbs, monkeypatch, chunked, Z,
                                            nbcov_gt1):
    """The count core's packed [R, 2K+2] output (top-K counts and
    peptides in PreScore order, matched totals, scored counts) equals
    sage_tpu's ``_device_open_count`` for both entry layouts, one and two
    fragment-charge planes, and one or several covered bands."""
    jos, tos = _searchers(dbs, 4 if nbcov_gt1 else 1, monkeypatch, Z=Z)
    sweep = None if Z > 1 else 2
    arrays = _arrays(dbs[0], 16, 13, charge=sweep)
    masses, intens, rows, u0, u1 = _batch_inputs(dbs, arrays, prec=OPEN)
    st, ln = jos.ranges(masses, Z, u0, u1)
    Pk = masses.shape[1]
    nbcov = st.shape[1] // (Z * Pk)
    assert (nbcov > 1) == nbcov_gt1
    monkeypatch.setenv("SAGE_TPU_OPEN_CHUNKED", "1" if chunked else "0")
    _st, _ln, _pk, ch, _size, Wc, F, _nb = jos._geometry(masses, rows, Z,
                                                         (st, ln))
    assert ch == chunked
    n = rows["si"].size
    R = 1 << max(n - 1, 7).bit_length()
    row_spec = np.full(R, masses.shape[0], np.int32)
    row_i0 = np.zeros(R, np.int32)
    row_i1 = np.zeros(R, np.int32)
    row_maxz = np.full(R, 2, np.int32)
    row_spec[:n] = rows["si"]
    row_i0[:n] = rows["i0"]
    row_i1[:n] = rows["i1"]
    row_maxz[:n] = np.maximum(rows["z"], 2)
    args = (st, ln, row_spec, row_i0, row_i1, row_maxz)
    kw = dict(F=F, Wc=Wc, Pk=Pk, Z=Z, K=50, R=R, chunked=chunked,
              nbcov=nbcov)
    want = np.asarray(jopen._device_open_count(
        jos.frag_pep8_dev, *(jnp.asarray(a) for a in args), **kw,
        psort=False))
    got = topen._device_open_count(
        tos.frag_pep8_dev, *(torch.from_numpy(a) for a in args), **kw,
        n_pep=tos.n_pep).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (want[:, 0] > 0).sum() >= n // 2
    if Z > 1:
        assert len(set(rows["z"].tolist())) > 1


def _stream_both(js, ts, arrays, cuts):
    jb = [_spectra(jproc, arrays[a:b]) for a, b in cuts]
    tb = [_spectra(tproc, arrays[a:b]) for a, b in cuts]
    return list(js.score_stream(jb)), list(ts.score_stream(tb))


def _plans(monkeypatch, ts):
    """Record the port's last_plan after every dispatch."""
    plans = []
    real = ts._fused_dispatch

    def dispatch(*a, **k):
        d = real(*a, **k)
        plans.append(dict(ts.last_plan))
        return d

    monkeypatch.setattr(ts, "_fused_dispatch", dispatch)
    return plans


@pytest.mark.parametrize(
    "case", ["host_then_device", "slot_classes", "split", "charge_sweep",
             "sticky_overflow", "every_class_empty"])
def test_open_tables_match_sage_tpu(dbs, monkeypatch, case):
    """score_table / score_stream at -500/+100 Da: every FeatureTable
    column equals sage_tpu's for each planning case of the open branch."""
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
    kw = dict(report_psms=2)
    charge = 2
    if case == "charge_sweep":
        kw.update(min_precursor_charge=2, max_precursor_charge=4,
                  min_matched_peaks=1)
        charge = None
    if case == "slot_classes":
        kw.update(min_isotope_err=-1, max_isotope_err=1,
                  override_precursor_charge=True)
        monkeypatch.setenv("SAGE_TPU_OPEN_BANDS", "16")
    if case == "split":
        kw.update(min_isotope_err=-1, max_isotope_err=1)
    n = {"slot_classes": 192, "host_then_device": 48}.get(case, 24)
    arrays = _arrays(dbs[0], n, {"split": 21, "slot_classes": 17}.get(case, 11),
                     charge=charge)
    js, ts = _scorers(dbs, **kw)
    plans = _plans(monkeypatch, ts)

    if case == "split":
        # a budget that forces exactly one split level (each half fits)
        masses, *_ = ts._pad_peaks(_spectra(tproc, arrays))
        rows = ts._expand_rows(_spectra(tproc, arrays))
        Zb = min(int(np.maximum(rows["z"], 2).max()) - 1, ts.Z)
        *_, size, _, _, nbcov = ts._open_searcher()._geometry(
            masses, rows, Zb, None)
        budget = len(arrays) * nbcov * (int(size.max()) + 1) - 1
        monkeypatch.setattr(jopen.OpenSearcher, "MAX_ELEMENTS", budget)
        monkeypatch.setattr(topen.OpenSearcher, "MAX_ELEMENTS", budget)
        ts._open = None
    if case in ("host_then_device", "slot_classes"):
        step = n // 3 if case == "slot_classes" else 16
        cuts = [(i, i + step) for i in range(0, n, step)]
        j_t, t_t = _stream_both(js, ts, arrays, cuts)
        # the stream again: every batch device-planned
        j_t2, t_t2 = _stream_both(js, ts, arrays, cuts)
        j_t += j_t2
        t_t += t_t2
        assert [p["device_planned"] for p in plans] == \
            [False] + [True] * (2 * len(cuts) - 1)
        if case == "slot_classes":
            st = ts._open_searcher()._sticky_shapes
            assert len(st["classes"]) >= 2 and st["alpha"]
            assert any(len(p["F"]) >= 2 for p in plans[1:]), plans
    elif case in ("sticky_overflow", "every_class_empty"):
        half = n // 2
        j_t = [js.score_table(_spectra(jproc, arrays[:half]))]
        t_t = [ts.score_table(_spectra(tproc, arrays[:half]))]
        if case == "sticky_overflow":
            for sc_os in (js._open_searcher(), ts._open_searcher()):
                # below this batch's slot totals (> 100 entries), above K
                for cl in sc_os._sticky_shapes["classes"]:
                    cl["F"] = 64
                    cl["Wc"] = 8
                sc_os._sticky_shapes["F"] = 64
                sc_os._sticky_shapes["Wc"] = 8
            two = []
            real_two = ts._two_dispatch
            monkeypatch.setattr(ts, "_two_dispatch",
                                lambda *a: two.append(1) or real_two(*a))
        else:
            # no live slot in any class: the single-class layout
            real = ts._open_searcher().est_band_sizes

            def no_live(*a):
                est, valid = real(*a)
                return est, np.zeros_like(valid)

            monkeypatch.setattr(ts._open_searcher(), "est_band_sizes",
                                no_live)
            ts._open_searcher()._sticky_shapes["alpha"] = 1.0
            ts._open_searcher()._sticky_shapes["classes"].insert(
                0, {"F": 128, "Wc": 8})
        j_t.append(js.score_table(_spectra(jproc, arrays[half:])))
        t_t.append(ts.score_table(_spectra(tproc, arrays[half:])))
        assert plans[1]["device_planned"] and len(plans[1]["F"]) == 1
        if case == "sticky_overflow":
            # the overflowed batch reruns through the two-dispatch path,
            # as in sage_tpu: no third fused plan
            assert ts.fused_reruns == 1 == js.fused_reruns
            assert len(plans) == 2 and two == [1]
            assert ts._open_searcher()._sticky_shapes == \
                js._open_searcher()._sticky_shapes
            assert ts._open_searcher()._sticky_shapes["F"] > 64
        else:
            assert ts.fused_reruns == 0
    else:
        j_t = [js.score_table(_spectra(jproc, arrays))]
        t_t = [ts.score_table(_spectra(tproc, arrays))]
        if case == "split":
            assert len(plans[0]["plan"]) == 2
        else:
            assert len(set(t_t[0].columns["charge"].tolist())) > 1
            assert ts.Z > 1
    assert all(p.get("open") for p in plans)
    assert sum(len(t) for t in t_t) > 0
    for a, b in zip(j_t, t_t):
        assert_tables_equal(a, b, skip=("psm_id",))


def test_open_topk_beyond_64(dbs, monkeypatch):
    """K > 64 (report_psms = 40, K = 80): the port keeps an exact top-K.
    Where sage_tpu's count core takes lax.top_k (entry axis <= 8192;
    +-0.5 Da fragments) the tables equal sage_tpu's; on a longer axis
    (unbanded, +-8 Da fragments) they equal the port's own
    candidate-major path."""
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
    kw = dict(report_psms=40, min_matched_peaks=1)
    arrays = _arrays(dbs[0], 12, 29)
    js, ts = _scorers(dbs, frag=("da", -0.5, 0.5), **kw)
    assert ts.K == 80
    t_j = js.score_table(_spectra(jproc, arrays))
    t_p = ts.score_table(_spectra(tproc, arrays))
    assert max(ts.last_plan["F"]) <= 8192
    assert (t_p.columns["rank"] > 32).any()
    assert_tables_equal(t_j, t_p, skip=("psm_id",))

    monkeypatch.setenv("SAGE_TPU_OPEN_BANDS", "1")
    wide = ("da", -8.0, 8.0)
    arrays = _arrays(dbs[0], 4, 31)
    _js, ts = _scorers(dbs, frag=wide, **kw)
    t_open = ts.score_table(_spectra(tproc, arrays))
    assert max(ts.last_plan["F"]) > 8192
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "999999999")
    _js, ts2 = _scorers(dbs, frag=wide, **kw)
    t_cand = ts2.score_table(_spectra(tproc, arrays))
    assert not ts2.last_plan.get("open")
    assert (t_cand.columns["rank"] > 32).any()
    assert_tables_equal(t_cand, t_open, skip=("psm_id",))


def test_open_long_rows_match_sage_tpu(dbs, monkeypatch):
    """Entry rows of more than 46,341 keys (one band, +-40 Da fragments),
    where a count packed beside its position no longer fits 31 bits and
    the rows sort past the 2^15-key one-pass limit (the hierarchical
    path): every FeatureTable column equals sage_tpu's (K = 50, where its
    tournament top-K is exact)."""
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
    monkeypatch.setenv("SAGE_TPU_OPEN_BANDS", "1")
    widths = []
    real = topen.bitonic_sort_rows
    monkeypatch.setattr(
        topen, "bitonic_sort_rows",
        lambda x, *a, **k: widths.append(x.shape[1]) or real(x, *a, **k))
    arrays = _arrays(dbs[0], 4, 31)
    js, ts = _scorers(dbs, frag=("da", -40.0, 40.0), report_psms=2,
                      min_matched_peaks=1)
    assert ts.K == 50
    t_j = js.score_table(_spectra(jproc, arrays))
    t_p = ts.score_table(_spectra(tproc, arrays))
    assert max(ts.last_plan["F"]) > 46341 and max(widths) > (1 << 15)
    assert (t_p.columns["rank"] > 1).any()
    assert_tables_equal(t_j, t_p, skip=("psm_id",))


def test_open_searcher_state_matches_sage_tpu(dbs, monkeypatch):
    """The band layout and the sticky planning state that the host-
    planned teaching batch records equal sage_tpu's."""
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
    monkeypatch.setenv("SAGE_TPU_OPEN_BANDS", "16")
    js, ts = _scorers(dbs, min_isotope_err=-1, max_isotope_err=1,
                      override_precursor_charge=True)
    arrays = _arrays(dbs[0], 64, 17)
    js.score_table(_spectra(jproc, arrays))
    ts.score_table(_spectra(tproc, arrays))
    jo, to = js._open_searcher(), ts._open_searcher()
    assert (to.n_bands, to.band_w) == (jo.n_bands, jo.band_w)
    np.testing.assert_array_equal(to.band_off, jo.band_off)
    np.testing.assert_array_equal(to.frag_pep8_dev.numpy(),
                                  np.asarray(jo.frag_pep8_dev))
    assert to._sticky_shapes == jo._sticky_shapes
    assert len(to._sticky_shapes["classes"]) >= 2



# ---- the card kernels' algorithms against the plain versions ---------------
# Numpy models of csrc/peak_ranges.cu (open form), csrc/open_entries.cu and
# csrc/open_count.cu (tests/_peak_cases.py) at the edges each kernel has to
# get right; exact equality, no tolerance. The card tests hold the kernels
# themselves against the plain versions on the same generators.

RANGE_TOLS = {"ppm": ("ppm", -10.0, 10.0), "pct": ("pct", -0.001, 0.002),
              "da": ("da", -0.02, 0.02)}


@pytest.mark.parametrize("form", ["grid", "slots"])
@pytest.mark.parametrize("Zb", [1, 3])
@pytest.mark.parametrize("tol", sorted(RANGE_TOLS))
def test_peak_ranges_open_model(tol, Zb, form):
    """The open range search's binary searches (lower and upper bound over
    the band's masses, the span shortcut, invalid slots, an empty band)
    equal the plain three-level probe, with peaks at centres whose
    fragments lie exactly on their IEEE bounds and one ulp either side
    (at z = 1 and z = 2), NaN, -inf, 0 and +inf pads."""
    t = RANGE_TOLS[tol]
    frag_mz, off, cs = pc.range_masses(t, seed=Zb)
    tabs = pc.open_range_tables(topen, frag_mz, off, "cpu")
    B, Pk = 7, 16
    masses = pc.range_peaks(cs, B, Pk, seed=Zb)
    peaks = torch.from_numpy(np.stack([masses, np.ones_like(masses)]))
    nb = off.size - 1
    rng = np.random.default_rng(Zb)
    if form == "grid":
        nbcov = 3
        band = rng.integers(0, nb, (B, nbcov))
        valid = rng.random((B, nbcov)) < 0.8
        want = pc.model_open_ranges(tabs, masses, band.reshape(-1),
                                    valid.reshape(-1), nsub=nbcov, Zb=Zb,
                                    tol=t)
        got = topen._device_ranges(tabs, peaks, torch.from_numpy(band),
                                   torch.from_numpy(valid), Zb=Zb, tol=t)
    else:
        NS = 11
        spec = rng.integers(0, B, NS)
        band = rng.integers(0, nb, NS)
        valid = rng.random(NS) < 0.8
        want = pc.model_open_ranges(tabs, masses, band, valid, nsub=1,
                                    Zb=Zb, tol=t, spec=spec)
        got = topen._device_ranges_flat(
            tabs, peaks, torch.from_numpy(spec), torch.from_numpy(band),
            torch.from_numpy(valid), Zb=Zb, tol=t)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert want[1].sum() > 0 and (want[1] == 0).any()


@pytest.mark.parametrize("tile", [None, (5, 7)], ids=["tile", "tiles"])
@pytest.mark.parametrize("overflow", [False, True], ids=["fits", "overflow"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "neg"])
@pytest.mark.parametrize("nbcov", [1, 3])
@pytest.mark.parametrize("Z", [1, 3])
@pytest.mark.parametrize("chunked", [False, True], ids=["flat", "chunked"])
def test_open_entries_model(chunked, Z, nbcov, packed, overflow, tile):
    """The entry gather's capped scan, owner map, copies through it, tail
    fill and overflow fix-up write the plain version's rows element for
    element (keys, tags and live counts), empty windows, shared table
    rows and -1 pads included, and rows whose total passes F (or Wc
    table rows): the same truncation, entry F - 1 of the flat layout read
    through the last window as the plain version's clipped marks make it.
    ``tiles`` cuts the windows into tiles of 5 and the owner map into
    slices of 7 units, so the capped carry crosses tiles and windows
    cross slices (the kernel's 2048-window tiles and 4096-unit slices at
    12,000 peaks and long rows)."""
    Pk, F, Wc = 8, 384, 8
    pep, starts, lens = pc.entries_case(
        Z * 10 + nbcov, B=5, nbcov=nbcov, Z=Z, Pk=Pk, chunked=chunked, F=F,
        Wc=Wc, overflow=overflow)
    kw = dict(F=F, Wc=Wc, Pk=Pk, Z=Z, nbcov=nbcov, chunked=chunked,
              packed=packed)
    keys, tags, got_live = topen.open_entries(
        torch.from_numpy(pep.reshape(-1, 64)), torch.from_numpy(starts),
        torch.from_numpy(lens), **kw)
    w_keys, w_tags, w_live = pc.model_entries(
        pep, starts, lens, **kw,
        **(dict(tile=tile[0], unit_tile=tile[1]) if tile else {}))
    np.testing.assert_array_equal(keys.numpy(), w_keys)
    assert (tags is None) == (w_tags is None)
    if tags is not None:
        np.testing.assert_array_equal(tags.numpy(), w_tags)
    live = pc.live_count(w_keys, packed)
    np.testing.assert_array_equal(got_live.numpy(), w_live)
    np.testing.assert_array_equal(w_live, live)
    assert live.max() > 0
    W = Wc * 64 if chunked else F
    # an overflowing row: more entries than its W columns hold
    assert (lens[0].sum() > W) == overflow
    assert live.max() >= W - 1 or not (overflow and not chunked)


@pytest.mark.parametrize("cap", [None, "small"])
@pytest.mark.parametrize("K", [50, 64, 80])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "neg"])
@pytest.mark.parametrize("nbcov", [1, 4])
@pytest.mark.parametrize("Z", [1, 3])
def test_open_count_model(Z, nbcov, packed, K, cap):
    """The run-count top-K's binary searches of every band pseudo-row's
    window [a, b) within the gather's live prefix, run walk and K-sized
    threshold buffer (the warp form at K 50 and 64, the block form at 80)
    equal the plain version: ties in count (runs of 1-6 entries), padding
    query rows, empty and every-band precursor ranges, a row cut at F
    with live entries past it, an all-empty row, one top-K over nbcov
    band pseudo-rows against the plain version's per-band top-K and
    merge. ``small`` shrinks the model's buffer (and the block form's
    step) so that it compacts many times."""
    F, W = 512, 640
    case = pc.count_case(
        Z + 7 * nbcov + K, B=6, nbcov=nbcov, F=F, W=W, Z=Z, packed=packed,
        R=40, max_run=3)
    rows, zs = case[:2]
    kw = dict(F=F, K=K, nbcov=nbcov, Z=Z, packed=packed)
    got = topen.open_count(
        torch.from_numpy(rows), None if zs is None else torch.from_numpy(zs),
        *(torch.from_numpy(a) for a in case[2:]), **kw).numpy()
    # a buffer of 8 keys more than K and a step's keys: the warp form's
    # 32-position steps, or the block form's cut to 16 positions
    mkw = {}
    if cap:
        mkw = (dict(cap=K + 40) if K <= pc.WARP_MAX_K
               else dict(cap=K + 24, step=16))
    want = pc.model_count(*case, **kw, **mkw)
    np.testing.assert_array_equal(got, want)
    assert (want[:, K - 1] > 0).any()  # some rows fill their K
    assert (want[:, 0] == 0).any() and (want[:, 0] > 0).any()
    # ties: equal counts with different peptides in one row
    v = want[:, :K]
    assert ((v[:, 1:] == v[:, :-1]) & (v[:, 1:] > 0)).any()


def test_warp_first_model():
    """The count kernel's searches (the warp form's G-lane search for each
    end of each band pseudo-row's window, G 1 to 16 as the number of rows
    searched at once gives it, and the block form's binary search) find
    the first true position of every monotone predicate on ranges of
    every length up to 3000."""
    assert [pc.search_group(ns) for ns in (1, 2, 3, 4, 5, 8, 9, 16)] == \
        [16, 8, 4, 4, 2, 2, 1, 1]
    for n in list(range(0, 70)) + [1000, 1023, 1024, 1025, 2999]:
        for t in {0, 1, n // 3, n - 1, n, n + 5}:
            if 0 <= t <= n:
                assert pc.first_true(0, n, lambda j: j >= t) == t
                assert pc.first_true(3, n + 3,
                                     lambda j: j >= t + 3) == t + 3
                for G in (1, 2, 4, 8, 16):
                    assert pc.group_first(0, n, lambda j: j >= t, G) == t
                    assert pc.group_first(3, n + 3, lambda j: j >= t + 3,
                                          G) == t + 3


@pytest.mark.parametrize("max_run", [1, 40])
@pytest.mark.parametrize("K", [1, 50, 64])
def test_open_count_forms_agree(K, max_run):
    """The count model's warp form (the kernel's for K <= 64) and block
    form on the same input give the plain version's output: on rows of
    thousands of runs of one entry, where the warp form's buffer (128
    keys for every K up to 64) fills and compacts many times behind its
    threshold, and on runs of up to 40 entries of three charge planes,
    which stay open across the warp form's 32-position steps."""
    F = W = 4096
    Z = 1 if max_run == 1 else 3
    case = pc.count_case(11, B=3, nbcov=1, F=F, W=W, Z=Z, packed=True, R=5,
                         band_w=20000, max_run=max_run)
    rows, zs, live, spec, i0, i1, maxz = case
    i0[:], i1[:] = 0, 20000
    spec[:] = [0, 2, 0, 2, 1]  # pseudo-row 1 holds no entries
    kw = dict(F=F, K=K, nbcov=1, Z=Z, packed=True)
    want = topen.open_count_plain(*(None if a is None
                                     else torch.from_numpy(a)
                                     for a in case), **kw).numpy()
    for form in ("warp", "block"):
        np.testing.assert_array_equal(
            pc.model_count(*case, **kw, form=form), want)
    # runs scored in a row
    assert want[:, 2 * K + 1].max() > (3000 if max_run == 1 else 150)
    assert pc.count_buffer(K, 32) == 128


@pytest.mark.parametrize("chunked", [False, True], ids=["flat", "chunked"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "neg"])
def test_open_entries_live_count(chunked, packed):
    """The gather's live count equals the count of each row's live keys,
    in both layouts and both key forms: rows past F (the flat fix-up's
    entry counted once), windows over the table's -1 pads (read, not
    live), empty rows; and it is the live prefix of the sorted rows that
    the count reads."""
    Pk, F, Wc, Z, nbcov = 8, 384, 8, 3, 3
    pep, starts, lens = pc.entries_case(
        7, B=5, nbcov=nbcov, Z=Z, Pk=Pk, chunked=chunked, F=F, Wc=Wc,
        overflow=True)
    lens[2] = 0  # a spectrum with no entries
    starts[1, 0], lens[1, 0] = pep.size - 70, 10  # ten of the -1 pads
    kw = dict(F=F, Wc=Wc, Pk=Pk, Z=Z, nbcov=nbcov, chunked=chunked,
              packed=packed)
    keys, _tags, live = topen.open_entries(
        torch.from_numpy(pep.reshape(-1, 64)), torch.from_numpy(starts),
        torch.from_numpy(lens), **kw)
    want = pc.live_count(keys.numpy(), packed)
    np.testing.assert_array_equal(live.numpy(), want)
    np.testing.assert_array_equal(
        pc.model_entries(pep, starts, lens, **kw)[2], want)
    assert want.min() == 0 and want.max() >= (F - 1 if not chunked else 1)
    empty = pc.INT32_MAX if packed else pc.NOPEP
    srt = np.sort(keys.numpy(), axis=1)
    for r, n in enumerate(want):
        assert (srt[r, :n] != empty).all() and (srt[r, n:] == empty).all()
    # the flat rows read some -1 pads among their entries
    if not chunked:
        total = np.minimum(lens.reshape(5, Z, nbcov, Pk).sum(axis=(1, 3)),
                           F).reshape(-1)
        assert (want < total).any()


def test_open_entries_smem_has_no_peak_ceiling():
    """The gather kernel's shared memory (the model's sizing, which the
    card test holds against the kernel's own): one tile's capped prefix,
    starts and lengths, 12 bytes a
    window and 4 more, and a slice of the owner map, 2 bytes a unit,
    rounded up to 16: 4,612 + 2,560 bytes at Pk 128 with Z 3 and an F of
    1,280, and at the 12,000 peaks of max_peaks 12,000 with Z 3 (36,000
    windows) and F 65,536 one 2048-window tile and one 4096-unit slice,
    what any larger Pk or row takes, within the 48 KB a block has without
    opting in."""
    smem = pc.entries_smem_bytes
    assert smem(3, 128, 1280) == 12 * 3 * 128 + 4 + 2 * 1280 == 7172
    top = 12 * pc.ENTRIES_TILE + 4 + 2 * pc.ENTRIES_UNIT_TILE
    assert smem(3, 12000, 65536) == top == smem(4, 10**6, 10**6) == 32772
    assert top <= 48 * 1024
    for Z, Pk, u in ((1, 1, 1), (2, 100, 8), (3, 682, 4096), (1, 2048, 9)):
        assert smem(Z, Pk, u) == 12 * Z * Pk + 4 + -(-2 * u // 16) * 16


@pytest.mark.parametrize("nbcov_gt1", [False, True], ids=["nbcov1", "nbcovN"])
@pytest.mark.parametrize("Z", [1, 2])
@pytest.mark.parametrize("chunked", [False, True], ids=["flat", "chunked"])
def test_kernel_models_match_sage_tpu(dbs, monkeypatch, chunked, Z,
                                      nbcov_gt1):
    """The gather and count models, with a plain sort between them, give
    sage_tpu's ``_device_open_count`` output on a real batch (the setup of
    test_device_open_count_matches_sage_tpu)."""
    jos, tos = _searchers(dbs, 4 if nbcov_gt1 else 1, monkeypatch, Z=Z)
    arrays = _arrays(dbs[0], 16, 13, charge=None if Z > 1 else 2)
    masses, intens, rows, u0, u1 = _batch_inputs(dbs, arrays, prec=OPEN)
    st, ln = jos.ranges(masses, Z, u0, u1)
    Pk = masses.shape[1]
    nbcov = st.shape[1] // (Z * Pk)
    monkeypatch.setenv("SAGE_TPU_OPEN_CHUNKED", "1" if chunked else "0")
    _st, _ln, _pk, ch, _size, Wc, F, _nb = jos._geometry(masses, rows, Z,
                                                         (st, ln))
    n = rows["si"].size
    R = 1 << max(n - 1, 7).bit_length()
    spec = np.full(R, masses.shape[0], np.int32)
    i0 = np.zeros(R, np.int32)
    i1 = np.zeros(R, np.int32)
    maxz = np.full(R, 2, np.int32)
    spec[:n], i0[:n], i1[:n] = rows["si"], rows["i0"], rows["i1"]
    maxz[:n] = np.maximum(rows["z"], 2)
    want = np.asarray(jopen._device_open_count(
        jos.frag_pep8_dev, *(jnp.asarray(a) for a in (st, ln, spec, i0, i1,
                                                      maxz)),
        F=F, Wc=Wc, Pk=Pk, Z=Z, K=50, R=R, chunked=ch, nbcov=nbcov,
        psort=False))
    keys, _, live = pc.model_entries(np.asarray(jos.frag_pep8_dev), st, ln,
                                     F=F, Wc=Wc, Pk=Pk, Z=Z, nbcov=nbcov,
                                     chunked=ch, packed=True)
    got = pc.model_count(np.sort(keys, axis=1), None, live, spec, i0, i1,
                         maxz, F=F, K=50, nbcov=nbcov, Z=Z, packed=True)
    np.testing.assert_array_equal(got, want)
    assert (want[:, 0] > 0).sum() >= n // 2
