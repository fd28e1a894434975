"""The port's scenario families against the JAX package's
(``tests/test_scenarios.py``'s corpus).

The scenario layer is numpy code seeded with
``np.random.default_rng(seed)``; the port's copy draws the same numbers
in the same order, so every array of every family at a given seed is
equal to the reference's bit for bit: ``x, y, t, p, kind, obj`` and the
``(R, 6)`` track table, with the same dtypes, duration and name. The
same holds for ``make_scenario_suite``, ``make_fleet_recordings`` and a
composed scenario. The port's evaluation reads the ``(R, 6)`` tables:
its accuracy sweep over the scenario suite equals the reference's, with
the scan and the fleet driver.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import pipeline as JP
from repro.data import synthetic as JD
from repro_torch.core import pipeline as TP
from repro_torch.data import synthetic as TD

DUR = 0.6  # seconds; short but several tumble / jitter periods
FIELDS = ("x", "y", "t", "p", "kind", "obj", "rso_tracks")


def assert_recordings_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.duration_us, got.name) == (want.duration_us, want.name)


def test_registry_equals_reference():
    assert list(TD.SCENARIO_FAMILIES) == list(JD.SCENARIO_FAMILIES)
    for name, sc in TD.SCENARIO_FAMILIES.items():
        assert dataclasses.asdict(sc) == dataclasses.asdict(JD.SCENARIO_FAMILIES[name]), name
    assert dataclasses.asdict(TD.RSOSpec()) == dataclasses.asdict(JD.RSOSpec())
    assert TD.LENS_CONFIGS == JD.LENS_CONFIGS


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("fam", sorted(JD.SCENARIO_FAMILIES))
def test_family_arrays_equal_reference(fam, seed):
    got = TD.make_scenario(dataclasses.replace(TD.SCENARIO_FAMILIES[fam], duration_s=DUR), seed=seed)
    want = JD.make_scenario(dataclasses.replace(JD.SCENARIO_FAMILIES[fam], duration_s=DUR), seed=seed)
    assert_recordings_equal(got, want)
    assert got.rso_tracks.shape == (len(TD.SCENARIO_FAMILIES[fam].rsos), 6)
    assert np.all(np.diff(got.t) >= 0) and len(got) > 0


@pytest.mark.parametrize("lens", sorted(JD.LENS_CONFIGS))
def test_family_on_each_lens_equals_reference(lens):
    sc = dict(rsos=(JD.RSOSpec(tumble_hz=3.0),), lens=lens, n_bursts=2, hot_columns=1,
              jitter_px=1.0, duration_s=0.4)
    got = TD.make_scenario(TD.Scenario(name="mix", rsos=(TD.RSOSpec(tumble_hz=3.0),),
                                       **{k: v for k, v in sc.items() if k != "rsos"}),
                           seed=4, psf_sigma=1.1, width=320, height=240)
    want = JD.make_scenario(JD.Scenario(name="mix", **sc), seed=4, psf_sigma=1.1, width=320, height=240)
    assert_recordings_equal(got, want)


def test_scenario_suite_equals_reference():
    got = TD.make_scenario_suite(seed0=5, duration_s=0.3, n_per_family=2)
    want = JD.make_scenario_suite(seed0=5, duration_s=0.3, n_per_family=2)
    assert len(got) == len(want) == 2 * len(JD.SCENARIO_FAMILIES)
    for g, w in zip(got, want):
        assert_recordings_equal(g, w)
    fams = ("crossing", "hot_columns")
    for g, w in zip(TD.make_scenario_suite(fams), JD.make_scenario_suite(fams)):
        assert_recordings_equal(g, w)  # the family's own duration (2 s)


@pytest.mark.parametrize("scenario", [None, "tumbling", "jitter"])
def test_fleet_recordings_equal_reference(scenario):
    kw = dict(seed0=3, duration_s=0.25, jitter_px=2.0, jitter_hz=5.0)
    got = TD.make_fleet_recordings(8, scenario=scenario and TD.SCENARIO_FAMILIES[scenario], **kw)
    want = JD.make_fleet_recordings(8, scenario=scenario and JD.SCENARIO_FAMILIES[scenario], **kw)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert_recordings_equal(g, w)
    if scenario is None:  # cycles the families
        assert len({r.name.split("-", 1)[1] for r in got}) == len(TD.SCENARIO_FAMILIES)


def test_ballistic_positions_follow_the_quadratic_table():
    rec = TD.make_scenario(dataclasses.replace(TD.SCENARIO_FAMILIES["ballistic"], duration_s=DUR), seed=11)
    ref = JD.make_scenario(dataclasses.replace(JD.SCENARIO_FAMILIES["ballistic"], duration_s=DUR), seed=11)
    t_us = np.array([0.0, 2.5e5, 6e5])
    for r in range(rec.rso_tracks.shape[0]):
        np.testing.assert_array_equal(np.stack(rec.rso_position(r, t_us)),
                                      np.stack(ref.rso_position(r, t_us)))
    assert np.any(np.hypot(rec.rso_tracks[:, 4], rec.rso_tracks[:, 5]) > 1.0)


def test_scenario_sweep_equals_reference_with_both_drivers():
    """The port's sweep (default config, on the CPU) over the reference's
    four-family scenario suite equals the reference's scan-driver sweep,
    with the port's scan and fleet drivers: the (R, 6) tables gate the
    curved tracks identically."""
    fams = ("crossing", "ballistic", "tumbling", "geo_slow")
    suite_t = TD.make_scenario_suite(families=fams, duration_s=0.35)
    suite_j = JD.make_scenario_suite(families=fams, duration_s=0.35)
    thresholds = (2, 5, 8)
    want = JP.threshold_sweep(suite_j, thresholds=thresholds)
    for driver in ("scan", "fleet"):
        got = TP.threshold_sweep(suite_t, thresholds=thresholds, driver=driver, device="cpu")
        assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
            {k: dataclasses.astuple(v) for k, v in want.items()}, driver
