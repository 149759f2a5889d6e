"""The port on a CUDA device: the stage-1 and bitonic-sort kernels against
their plain versions on the card, and the whole narrow and open paths on
the card against the CPU.
Every test here needs a card; where there is none they skip.

Run on a machine with a card (the variable keeps conftest.py from
importing jax, which that machine may not have):
    SAGE_TPU_TEST_PLATFORM=cuda python -m pytest tests/test_torch_gpu.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from sage_tpu_torch.bench_baseline import synth_fasta, synth_spectra
from sage_tpu_torch.chem.fasta import Fasta
from sage_tpu_torch.chem.mass import Tolerance
from sage_tpu_torch.index.builder import DatabaseParams
from sage_tpu_torch.ops import pallas_sort, pallas_stage1
from sage_tpu_torch.ops.search import Scorer, SearchParams

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small(cuda):
    params = DatabaseParams()
    db = params.build(Fasta.parse(synth_fasta(300), params.decoy_tag, True))
    spectra = synth_spectra(db, 256, seed=5)
    for i, s in enumerate(spectra):
        s.precursors[0].charge = 2 + i % 2
    return db, spectra


def _params(frag):
    return SearchParams(
        precursor_tol=Tolerance("da", -5.0, 5.0),
        fragment_tol=Tolerance(*frag), min_isotope_err=-1,
        max_isotope_err=1, report_psms=2, min_matched_peaks=2,
    )


@pytest.mark.parametrize("W", [8, 40, 64, 256])
@pytest.mark.parametrize("Z", [1, 3])
@pytest.mark.parametrize("frag", [("ppm", -10.0, 10.0), ("da", -0.02, 0.02)])
def test_stage1_kernel_matches_plain(cuda, small, W, Z, frag):
    db, spectra = small
    s = Scorer(db, _params(frag), device=cuda)
    masses, intens, Pk = s._pad_peaks(spectra[:32])
    peaks = torch.from_numpy(masses).to(cuda)
    rng = np.random.default_rng(W * 7 + Z)
    R = 200
    P_pad = s.tables.P_pad
    p0 = rng.integers(0, len(db) - W, R)
    i0 = p0 + rng.integers(0, W // 4 + 1, R)
    ints = np.stack([
        rng.integers(0, 34, R), p0, i0, i0 + rng.integers(0, W + 1, R),
        rng.choice([2, 3, 4], R),
    ]).astype(np.int32)
    ints[1] = np.minimum(ints[1], P_pad - W)
    ints_d = torch.from_numpy(ints).to(cuda)
    for Lc in (12, s.tables.L):
        kw = dict(W=W, Lc=Lc, Z=Z, tol=frag)
        before = pallas_stage1.launches
        got = pallas_stage1.stage1_counts(s.tables.lad_index, peaks, ints_d,
                                          **kw)
        assert pallas_stage1.launches == before + 1
        want = pallas_stage1.stage1_counts_plain(s.tables.lad_index, peaks,
                                                 ints_d, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert (want[:, :W] > 0).any()


def test_narrow_path_card_matches_cpu(cuda, small):
    db, spectra = small
    params = _params(("ppm", -10.0, 10.0))
    before = pallas_stage1.launches
    t_gpu = Scorer(db, params, device=cuda).score_table(spectra)
    assert pallas_stage1.launches > before
    t_cpu = Scorer(db, params, device="cpu").score_table(spectra)
    assert len(t_gpu) == len(t_cpu) > 0
    for k in t_cpu.columns:
        np.testing.assert_array_equal(t_gpu.columns[k], t_cpu.columns[k],
                                      err_msg=f"column {k}")


@pytest.mark.parametrize("B,F,block", [
    (3, 1, None), (7, 100, None), (64, 4096, None), (5, 32768, None),
    (4, 70000, None), (6, 5000, 1024), (3, 40000, 4096),
])
def test_sort_kernels_match_plain(cuda, B, F, block):
    """One-pass rows up to 2^15 keys and the hierarchical path (block
    sorts, flip/cross passes, merge kernel): bit-equal to the plain
    version and to torch.sort, with sentinel keys and duplicates."""
    rng = np.random.default_rng(B * 31 + F)
    x = rng.integers(-50, 50, size=(B, F)).astype(np.int32)
    x[:, F // 2:F // 2 + 7] = 2**31 - 1
    xd = torch.from_numpy(x).to(cuda)
    before = dict(pallas_sort.launches)
    got = pallas_sort.bitonic_sort_rows(xd, block=block)
    torch.cuda.synchronize()
    assert pallas_sort.launches["bitonic_sort"] == before["bitonic_sort"] + 1
    hier = (1 << max(F - 1, 0).bit_length()) > (block or pallas_sort._BLOCK_MAX)
    assert (pallas_sort.launches["bitonic_merge"]
            > before["bitonic_merge"]) == hier
    want = pallas_sort.bitonic_sort_rows(torch.from_numpy(x), block=block)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, torch.sort(xd, dim=1).values)


def test_open_path_card_matches_cpu(cuda, small, monkeypatch):
    """The open search (-500/+100 Da) on the card, sort kernel included,
    against the CPU: every FeatureTable column equal."""
    db, spectra = small
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
    params = SearchParams(
        precursor_tol=Tolerance("da", -500.0, 100.0),
        fragment_tol=Tolerance("ppm", -10.0, 10.0), report_psms=2,
    )
    before = pallas_sort.launches["bitonic_sort"]
    gpu = Scorer(db, params, device=cuda)
    t_gpu = list(gpu.score_stream([spectra[:96], spectra[96:192]]))
    assert gpu.last_plan.get("open")
    assert pallas_sort.launches["bitonic_sort"] > before
    cpu = Scorer(db, params, device="cpu")
    t_cpu = list(cpu.score_stream([spectra[:96], spectra[96:192]]))
    for a, b in zip(t_gpu, t_cpu):
        assert len(a) == len(b) > 0
        for k in b.columns:
            np.testing.assert_array_equal(a.columns[k], b.columns[k],
                                          err_msg=f"column {k}")
