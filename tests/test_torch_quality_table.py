"""The port's no-ground-truth quality table (scripts/quality_table_torch.py):
the reference's gates (tests/test_quality_table.py, the same margins) on
the port's fixtures, which are the reference's clips within 1 LSB, and the
reference's sway clip through both packages' ``measure``.

Parity tolerance, from the 1-LSB frame contract: the two packages'
stabilized frames differ by at most 1 LSB, on a few bytes in 1e5. LK
tracking turns such a difference into a sub-pixel shift of a few tracked
corners; the stability score, a ratio of spectral energies of a 64-sample
path, is the most sensitive column: the port's sway fixture, whose bytes
differ from the reference's by 1 LSB on 4e-5 of them, moved it by 0.014
through one ``measure`` (t_rms, crop and distortion did not move at their
rounding). So rows are held within 0.02 on the stability scores, 0.005 on
crop and distortion, and 0.02 px on the tracked path RMS.
"""

import importlib.util
import os

import numpy as np
import pytest

pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"stability": 0.02, "crop": 0.005, "distortion": 0.005, "t_rms": 0.02}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    from dvsg_tpu_torch.utils import checkpoint as ckpt
    params, mcfg = ckpt.load_npz(
        os.path.join(ROOT, "checkpoints", "flagship_fast.npz"))
    return _script("quality_table_torch"), params, mcfg


def test_committed_draws_are_the_reference_draws():
    want = _script("quality_fixture_draws").draws()
    with np.load(os.path.join(ROOT, "scripts",
                              "quality_fixture_draws.npz")) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("name", ["sway", "rot-sway", "zoom-sway",
                                  "handheld"])
def test_fixture_within_one_lsb_of_reference(setup, name):
    qt = setup[0]
    got = qt.make_fixture(name).astype(int)
    want = _script("quality_table").make_fixture(name).astype(int)
    assert got.shape == want.shape == (64, 256, 320, 3)
    assert np.abs(got - want).max() <= 1


def test_sway_fixture_trio(setup):
    qt, params, mcfg = setup
    row = qt.measure("sway", qt.make_fixture("sway"), params, mcfg, 32,
                     device="cpu")
    assert row["stability_smooth"] > row["stability_plain"] + 0.04, row
    assert row["t_rms_smooth"] < 0.60 * row["t_rms_plain"], row
    assert row["crop_smooth"] >= 0.99, row
    assert row["distortion_smooth"] >= 0.99, row


def test_handheld_fixture_trio(setup):
    qt, params, mcfg = setup
    row = qt.measure("handheld", qt.make_fixture("handheld"), params, mcfg,
                     32, device="cpu")
    # Mixed realistic motion: smoothing must still help, never hurt.
    assert row["stability_smooth"] >= row["stability_plain"] - 0.005, row
    assert row["t_rms_smooth"] < 0.85 * row["t_rms_plain"], row
    assert row["crop_smooth"] >= 0.995, row
    assert row["distortion_smooth"] >= 0.99, row


def test_reference_sway_clip_rows_match(setup):
    """The reference's own sway clip through both packages' measure."""
    from dvsg_tpu.utils import checkpoint as jckpt
    qt, params, mcfg = setup
    jqt = _script("quality_table")
    clip = jqt.make_fixture("sway")
    jparams, jmcfg = jckpt.load_npz(
        os.path.join(ROOT, "checkpoints", "flagship_fast.npz"))
    want = jqt.measure("sway", clip, jparams, jmcfg, 32)
    got = qt.measure("sway", clip, params, mcfg, 32, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        if k != "fixture":
            assert abs(got[k] - v) <= TOL[k.rsplit("_", 1)[0]], (k, got, want)
