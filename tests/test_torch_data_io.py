"""The port's recording interchange against the JAX package's
(``tests/test_data_io.py``'s corpus).

A ``.npz`` written by either package loads identically in the other, for
a legacy ``(R, 4)`` recording, a scenario recording with its ``(R, 6)``
table and a file holding only the required arrays. ``load_validation_suite``
orders files by name, never by creation order, and with no file falls
back to the synthetic suite, the reference's arrays; no download is
involved. The port's chunked replay concatenates back to the recording.
"""
import dataclasses

import numpy as np
import pytest

from repro.data import evas as JE
from repro.data import synthetic as JD
from repro_torch.data import evas as TE
from repro_torch.data import synthetic as TD
from test_torch_scenarios import assert_recordings_equal


def _recording(kind: str, pkg):
    if kind == "legacy":
        return pkg.make_recording(seed=5, duration_s=0.3, n_rsos=2)
    if kind == "no rso":
        return pkg.make_recording(seed=6, duration_s=0.2, n_rsos=0)
    sc = dataclasses.replace(pkg.SCENARIO_FAMILIES["ballistic"], duration_s=0.3)
    return pkg.make_scenario(sc, seed=9)


@pytest.mark.parametrize("kind", ["legacy", "no rso", "ballistic"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_npz_round_trips_across_packages(tmp_path, kind, writer):
    src, save = (TD, TE.save_recording) if writer == "port" else (JD, JE.save_recording)
    rec = _recording(kind, src)
    f = tmp_path / "rec.npz"
    save(rec, f)
    got, want = TE.load_recording(f), JE.load_recording(f)
    assert_recordings_equal(got, want)
    assert_recordings_equal(got, rec)


def test_minimal_file_loads_with_the_same_defaults(tmp_path):
    rec = TD.make_recording(seed=2, duration_s=0.1)
    f = tmp_path / "bare.npz"
    np.savez(f, x=rec.x, y=rec.y, t=rec.t, p=rec.p, duration_us=np.int64(rec.duration_us))
    got, want = TE.load_recording(f), JE.load_recording(f)
    assert_recordings_equal(got, want)
    assert got.name == "bare" and got.rso_tracks.shape == (0, 4)
    assert np.all(got.obj == -1) and np.all(got.kind == 0)


def test_suite_is_name_ordered_in_both_packages(tmp_path):
    base = TD.make_recording(seed=2, duration_s=0.2)
    for stem in ("bravo", "alpha", "delta", "charlie"):  # scrambled creation
        TE.save_recording(dataclasses.replace(base, name=stem), tmp_path / f"{stem}.npz")
    got, want = TE.load_validation_suite(tmp_path), JE.load_validation_suite(tmp_path)
    assert [r.name for r in got] == [r.name for r in want] == ["alpha", "bravo", "charlie", "delta"]
    for g, w in zip(got, want):
        assert_recordings_equal(g, w)


@pytest.mark.parametrize("where", ["none", "empty directory"])
def test_suite_falls_back_to_the_synthetic_suite(tmp_path, where):
    directory = None if where == "none" else tmp_path
    got, want = TE.load_validation_suite(directory), JE.load_validation_suite(directory)
    assert len(got) == len(want) == 18
    for g, w in zip(got, want):
        assert_recordings_equal(g, w)


def test_iter_chunks_matches_reference_and_partitions():
    rec = TD.make_scenario(dataclasses.replace(TD.SCENARIO_FAMILIES["noise_burst"], duration_s=0.3), seed=7)
    ref = JD.make_scenario(dataclasses.replace(JD.SCENARIO_FAMILIES["noise_burst"], duration_s=0.3), seed=7)
    got, want = list(TE.iter_chunks(rec, 20_000)), list(JE.iter_chunks(ref, 20_000))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for i, f in enumerate(("x", "y", "t", "p")):
        np.testing.assert_array_equal(np.concatenate([c[i] for c in got]), getattr(rec, f))
