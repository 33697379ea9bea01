"""The port's mirror plots (``viz.py`` and ``plot``) against the JAX
package's ``viz`` fed the same spectra: the same preprocessing and
theoretical spectrum exactly, and the same figure, read off the Axes:
every vline segment (m/z, base, height) and colour, every ion label with
its anchor, the limits and the title.  Host work: no card."""

import os

import matplotlib
import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu import viz as jviz
from specpride_tpu.data.peaks import Spectrum as JSpectrum
from specpride_tpu_torch import cli, viz
from specpride_tpu_torch.data.peaks import Spectrum
from specpride_tpu_torch.io import mgf

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _port(s):
    return Spectrum(s.mz, s.intensity, s.precursor_mz, s.precursor_charge,
                    s.rt, s.title)


def _figure(ax):
    """What a mirror plot draws: per vline collection its colour and
    segments; per annotation its text and anchor; limits and title."""
    import matplotlib.pyplot as plt

    lines = [(tuple(np.round(c.get_colors()[0], 6)),
              np.asarray(c.get_segments()).tolist())
             for c in ax.collections]
    texts = [(t.get_text(), tuple(t.xy), t.get_rotation())
             for t in ax.texts]
    out = (lines, texts, ax.get_ylim(), ax.get_title(), ax.get_xlabel())
    plt.close(ax.figure)
    return out


@pytest.fixture
def spectra(rng):
    c = make_cluster(rng, n_members=3, n_peaks=60)
    return c.members


def test_preprocess_and_theoretical_spectrum_equal_jax(spectra):
    for s in spectra:
        got, want = viz.preprocess(_port(s)), jviz.preprocess(s)
        np.testing.assert_array_equal(got.mz, want.mz)
        np.testing.assert_array_equal(got.intensity, want.intensity)
    for peptide, charge in (("PEPTIDEK", 2), ("VLHPLEGAVVIIFK", 3)):
        got = viz.theoretical_spectrum(peptide, charge)
        want = jviz.theoretical_spectrum(peptide, charge)
        np.testing.assert_array_equal(got.mz, want.mz)
        np.testing.assert_array_equal(got.intensity, want.intensity)
        assert got.title == want.title


@pytest.mark.parametrize("normalize", ["root", "linear"])
def test_mirror_plot_vs_consensus_draws_the_jax_figure(spectra, normalize):
    top, bottom = spectra[0], spectra[1]
    got = _figure(viz.mirror_plot(viz.preprocess(_port(top)),
                                  viz.preprocess(_port(bottom)),
                                  normalize=normalize))
    want = _figure(jviz.mirror_plot(jviz.preprocess(top),
                                    jviz.preprocess(bottom),
                                    normalize=normalize))
    assert got == want
    assert got[0]  # peaks were drawn


def test_mirror_plot_vs_theoretical_labels_the_jax_ions():
    """A spectrum on the fragment m/z (every peak matched and labelled)
    and the theoretical spectrum, annotated: the same labelled ions."""
    peptide = "PEPTIDEK"
    theo = viz.theoretical_spectrum(peptide, 2)
    jtheo = jviz.theoretical_spectrum(peptide, 2)
    spec = Spectrum(theo.mz, np.linspace(10, 90, theo.mz.size), 900.0, 2,
                    0.0, "m")
    jspec = JSpectrum(jtheo.mz, np.linspace(10, 90, jtheo.mz.size), 900.0,
                      2, 0.0, "m")
    got = _figure(viz.mirror_plot(spec, theo, annotate_peptide=peptide))
    want = _figure(jviz.mirror_plot(jspec, jtheo, annotate_peptide=peptide))
    assert got == want
    labels = {t[0] for t in got[1]}
    assert any(x.startswith("b") for x in labels)
    assert any(x.startswith("y") for x in labels)
    assert matplotlib.get_backend().lower() == "agg"


def test_plot_files_match_jax(spectra, tmp_path):
    rep = spectra[2]
    got = viz.plot_cluster_vs_consensus([_port(s) for s in spectra[:2]],
                                        _port(rep), str(tmp_path / "p"))
    want = jviz.plot_cluster_vs_consensus(spectra[:2], rep,
                                          str(tmp_path / "j"))
    assert [os.path.basename(p)[1:] for p in got] == \
        [os.path.basename(p)[1:] for p in want] == ["_0.png", "_1.png"]
    assert all(os.path.getsize(p) > 1000 for p in got)
    got = viz.plot_cluster_vs_theoretical([_port(spectra[0])], "PEPTIDEK", 2,
                                          str(tmp_path / "t"))
    assert got == [str(tmp_path / "t_0.png")]
    assert os.path.getsize(got[0]) > 1000


def test_cli_plot_modes(tmp_path, capsys, spectra):
    """``plot`` on the golden file: against its bin-mean representatives,
    against ``--peptide``, against the peptide a member's USI names, and
    its refusals (unknown cluster; no peptide known), with the JAX CLI's
    messages."""
    src = os.path.join(DATA, "golden_clustered.mgf")
    reps = os.path.join(DATA, "golden_bin_mean.mgf")
    cid = mgf.read_mgf(reps)[0].cluster_id
    n = sum(1 for s in mgf.read_mgf(src) if s.cluster_id == cid)
    assert cli.main(["plot", src, cid, str(tmp_path / "c"),
                     "--consensus", reps]) == 0
    paths = capsys.readouterr().out.split()
    assert paths == [str(tmp_path / f"c_{i}.png") for i in range(n)]
    assert all(os.path.getsize(p) > 1000 for p in paths)
    assert cli.main(["plot", src, cid, str(tmp_path / "t"),
                     "--peptide", "PEPTIDEK"]) == 0
    assert len(capsys.readouterr().out.split()) == n
    assert cli.main(["plot", src, "no-such-cluster", str(tmp_path / "x")]) \
        == 1
    assert "not found" in capsys.readouterr().err
    assert cli.main(["plot", src, cid, str(tmp_path / "u")]) == 0
    assert len(capsys.readouterr().out.split()) == n  # the USI's peptide
    bare = tmp_path / "bare.mgf"
    mgf.write_mgf([_port(s) for s in spectra], bare)
    assert cli.main(["plot", str(bare), spectra[0].cluster_id,
                     str(tmp_path / "y")]) == 1
    assert "pass --peptide" in capsys.readouterr().err


def test_cli_plot_direct_mzml(tmp_path, rng, capsys):
    """``plot`` on a raw mzML with its MaRaCluster TSV and msms.txt: the
    members titled as ``convert`` titles them, the first member's
    peptide drawn (the JAX CLI's ``test_plot_direct_mzml``)."""
    from test_torch_convert import _mzml_inputs

    from specpride_tpu_torch.io.maracluster import scan_to_cluster

    mzml, tsv, msms = _mzml_inputs(tmp_path, rng)
    cid = next(iter(scan_to_cluster(tsv).values()))
    n = sum(c == cid for c in scan_to_cluster(tsv).values())
    assert cli.main(["plot", mzml, cid, str(tmp_path / "m"), "--clusters",
                     tsv, "--msms", msms]) == 0
    paths = capsys.readouterr().out.split()
    assert paths == [str(tmp_path / f"m_{i}.png") for i in range(n)]
    assert all(os.path.getsize(p) > 1000 for p in paths)
