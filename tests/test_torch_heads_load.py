"""The port's `load_heads`, `load_reconstructed_heads` and model wrappers
against the JAX package's on the committed fixture artifact directory
(`tests/data/torch_artifacts/`, written by `tests/data/make_torch_artifacts.py`)
and on copies of it with heads missing.  The JAX package reads a copy whose
compressed joblib files are written out decompressed (its reader opens only
uncompressed streams); the port reads the committed files as they are."""
import json
import shutil
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu.models import heads as jheads
from fast_monte_carlo_tpu.models import wrappers as jw
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.models import heads as theads
from fast_monte_carlo_tpu_torch.models import wrappers as tw

from test_torch_support import (assert_same_forest, assert_same_heads, jax_readable_copy,
                                xgb_model_dict)

torch.set_num_threads(1)

ART = Path(fixtures.ARTIFACT_DIR)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    return jax_readable_copy(ART, tmp_path_factory.mktemp("jax") / "art")


@pytest.fixture(scope="module")
def both(jax_dir):
    return (theads.load_heads(ART, memoize=False), jheads.load_heads(jax_dir, memoize=False))


def test_fixture_directory_loads_as_jax(both):
    """Every head of the committed directory, equal to the JAX package's
    array for array, at the reference's shapes (a stale or broken
    directory fails here)."""
    port, jax = both
    assert_same_heads(port, jax)
    assert port.stage1.n_trees == 188 and port.stage1.layout.cat_group_sizes == (563,)
    assert [f.n_trees for f in port.pass_quants] == [400] * 3
    assert port.pass_quants[0].layout.cat_group_sizes == (563, 900)
    assert port.rush_quants[0].layout.cat_group_sizes == (700,)
    assert port.fumble.layout.cat_group_sizes == (700,) and port.fumble.n_trees == 104
    assert port.play.layout.cat_group_sizes == (168,) and port.play.n_classes == 5
    assert port.stage2.n_classes == 3
    assert port.stage2_class_order == ("incomplete", "intercepted", "sack")
    assert port.play_classes == ("field_goal", "pass", "punt", "run", "timeout")
    assert port.play_temperature == 1.3
    assert sum(p.stat().st_size for p in ART.iterdir()) < 4 * 2 ** 20


MISSING = {
    "stage1_model": ["pass_stage1_complete_vs_not.json"],
    "stage1_preprocessor": ["pass_stage1_preprocessor.joblib"],
    "stage2": ["pass_stage2_sklearn.joblib"],
    "stage2_classes": ["pass_stage2_classes.csv"],
    "a_quantile_head": ["run_yards_q50.joblib"],
    "sack_trio": ["sack_yards_q10.joblib", "sack_yards_q50.joblib", "sack_yards_q90.joblib"],
    "fumble": ["run_fumble_preprocessor.joblib"],
    "play_model": ["play_model.json"],
    "features": ["features.pkl"],
    "label_encoder": ["label_encoder.pkl"],
    "coach_encoder": ["coach_label_encoder.pkl"],
    "calibration": ["calibration.json"],
}


@pytest.mark.parametrize("case", sorted(MISSING))
def test_directories_missing_a_head_load_as_jax(tmp_path, jax_dir, case):
    port_dir, jdir = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(ART, port_dir)
    shutil.copytree(jax_dir, jdir)
    for name in MISSING[case]:
        (port_dir / name).unlink()
        (jdir / name).unlink()
    port = theads.load_heads(port_dir, memoize=False)
    assert_same_heads(port, jheads.load_heads(jdir, memoize=False))


def test_empty_and_missing_directories_load_as_jax(tmp_path):
    for d in (tmp_path, tmp_path / "absent"):
        assert_same_heads(theads.load_heads(d, memoize=False),
                          jheads.load_heads(d, memoize=False))
        assert theads.load_heads(d, memoize=False).stage1 is None


@pytest.mark.parametrize("where", ["fixture", "absent"])
def test_reconstructed_heads_equal_jax(tmp_path, jax_dir, where):
    """The committed overlay (stage 2, the temperature 1.45) over the
    fixture directory, and alone over a directory that does not exist."""
    pdir, jdir = (ART, jax_dir) if where == "fixture" else (tmp_path / "x", tmp_path / "x")
    port = theads.load_reconstructed_heads(pdir, memoize=False)
    assert_same_heads(port, jheads.load_reconstructed_heads(jdir, memoize=False))
    assert port.play_temperature == 1.45 and port.stage2.n_trees == 3
    assert (port.stage1 is None) == (where == "absent")


def test_heads_memo_shares_misses_and_evicts(tmp_path):
    """One shared instance while the files stand; a touched file misses;
    memoize=False is private; the memo keeps at most 16 entries, oldest
    out first; the overlay merge is memoized too."""
    d = tmp_path / "art"
    shutil.copytree(ART, d)
    t0 = time.perf_counter()
    a = theads.load_heads(d)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert theads.load_heads(d) is a
    assert time.perf_counter() - t0 < cold
    assert theads.load_heads(d, memoize=False) is not a
    (d / "run_fumble.json").touch()
    b = theads.load_heads(d)
    assert b is not a and theads.load_heads(d) is b
    assert_same_forest(b.fumble, a.fumble)
    r = theads.load_reconstructed_heads(d)
    assert theads.load_reconstructed_heads(d) is r and r.stage1 is b.stage1
    theads._HEADS_MEMO.clear()
    keys = []
    for i in range(theads._HEADS_MEMO_MAX + 1):
        (tmp_path / f"e{i}").mkdir()
        theads.load_heads(tmp_path / f"e{i}")
        keys.append(next(reversed(theads._HEADS_MEMO)))
    assert len(theads._HEADS_MEMO) == theads._HEADS_MEMO_MAX
    assert keys[0] not in theads._HEADS_MEMO and keys[1] in theads._HEADS_MEMO


def _rows(rng, n, lay):
    x = np.column_stack([rng.uniform(0, 10, n) if f != "seconds_remaining"
                         else rng.uniform(0, 3600, n) for f in lay.numeric_names])
    ids = {g: rng.integers(-1, 20, n) for g in lay.cat_group_names}
    return x.astype(np.float32), ids


def test_play_policy_and_quantile_yards_equal_jax(both, jax_dir):
    port, jax = both
    rng = np.random.default_rng(3)
    x, ids = _rows(rng, 512, port.play.layout)
    pp = tw.PlayPolicy(port.play, port.play_temperature, port.play_classes)
    jp = jw.PlayPolicy(jax.play, jax.play_temperature, jax.play_classes)
    np.testing.assert_allclose(pp.predict_proba(x, ids), jp.predict_proba(x, ids),
                               rtol=0, atol=1e-6)
    assert pp.sample_action(x[0], {g: v[:1] for g, v in ids.items()},
                            np.random.default_rng(5)) == \
        jp.sample_action(x[0], {g: v[:1] for g, v in ids.items()}, np.random.default_rng(5))
    qp = tw.QuantileYards.load(ART / "pass_yards")
    qj = jw.QuantileYards.load(Path(jax_dir) / "pass_yards")
    x, ids = _rows(rng, 512, qp.q50.layout)
    for a, b in zip(qp.quantiles(x, ids), qj.quantiles(x, ids)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        qp.sample(x, -20, 80, cat_ids=ids, rng=np.random.default_rng(8)),
        qj.sample(x, -20, 80, cat_ids=ids, rng=np.random.default_rng(8)), rtol=0, atol=1e-6)
    q10, q50, q90, u, z = (rng.normal(size=64).astype(np.float32) for _ in range(5))
    u = np.abs(u) % 1
    got = qp.sample_inverse_cdf_torch(*(torch.from_numpy(v) for v in (q10, q50, q90, u, z)))
    want = qj.sample_inverse_cdf_jnp(*(jnp.asarray(v) for v in (q10, q50, q90, u, z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_pass_outcome_wrappers_equal_jax(tmp_path, jax_dir):
    """PassOutcomeModel (a 4-class booster with a calibration file naming
    its best iteration) and PassOutcomeTwoStage (both stages cut at their
    best iterations), loaded from the same files by both packages."""
    rng = np.random.default_rng(11)
    d = tmp_path / "two"
    d.mkdir()
    for name in ("pass_stage1_preprocessor.joblib", "pass_stage1_complete_vs_not.json",
                 "pass_stage2_classes.csv"):
        shutil.copy(ART / name, d / name)
    shutil.copy(ART / "pass_stage1_preprocessor.joblib", d / "pass_stage2_preprocessor.joblib")
    n_feat = 563 + 17
    (d / "pass_stage2_notcomplete.json").write_text(json.dumps(xgb_model_dict(
        rng, n_feat, objective="multi:softprob", n_classes=3, rounds=6, cat_cols=563)))
    (d / "pass_outcome.json").write_text(json.dumps(xgb_model_dict(
        rng, n_feat, objective="multi:softprob", n_classes=4, rounds=6, cat_cols=563)))
    (d / "pass_stage1_meta.json").write_text(json.dumps({"best_iteration": 99}))
    (d / "pass_stage2_meta.json").write_text(json.dumps({"best_iteration": 3}))
    (d / "calib.json").write_text(json.dumps({"temperature": 1.2, "best_iteration": 4}))
    mp = tw.PassOutcomeModel.load(d / "pass_outcome.json", d / "pass_stage1_preprocessor.joblib",
                                  d / "calib.json")
    mj = jw.PassOutcomeModel.load(d / "pass_outcome.json", d / "pass_stage1_preprocessor.joblib",
                                  d / "calib.json")
    assert mp.temperature == mj.temperature == 1.2 and mp.forest.n_trees == 20
    x, ids = _rows(rng, 256, mp.forest.layout)
    np.testing.assert_allclose(mp.predict_proba(x, ids), mj.predict_proba(x, ids),
                               rtol=0, atol=1e-6)
    tp, tj = tw.PassOutcomeTwoStage.load(d), jw.PassOutcomeTwoStage.load(d)
    assert tp.stage2_classes == tj.stage2_classes and tp.stage1.n_trees == 100
    assert_same_forest(tp.stage2, tj.stage2)
    for target in (None, ids["passer_name"]):
        np.testing.assert_allclose(tp.predict_proba(x, ids["passer_name"], target),
                                   tj.predict_proba(x, ids["passer_name"], target),
                                   rtol=0, atol=1e-6)
