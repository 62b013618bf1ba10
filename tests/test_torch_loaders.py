"""The port's artifact readers (`compat.py`, `models/xgb_json.py`,
`models/sklearn_gbr.py`) against the JAX package's: XGBoost JSON and UBJSON
model dicts written here, joblib files trained here by the JAX package's own
recipes (`train/pipeline.py`), the committed reconstructed overlay, and
compressed files.  The port's reader needs neither sklearn nor joblib; the
forests compiled from what both read are equal array for array."""
import json
import os
import pickle
import struct
import subprocess
import sys
import types
from pathlib import Path

import joblib
import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu import compat as jcompat
from fast_monte_carlo_tpu.models import forest as jforest
from fast_monte_carlo_tpu.models import sklearn_gbr as jgbr
from fast_monte_carlo_tpu.models import xgb_json as jxgb
from fast_monte_carlo_tpu.train import pipeline as P
from fast_monte_carlo_tpu_torch import compat as tcompat
from fast_monte_carlo_tpu_torch.models import forest as tforest
from fast_monte_carlo_tpu_torch.models import sklearn_gbr as tgbr
from fast_monte_carlo_tpu_torch.models import xgb_json as txgb
from fast_monte_carlo_tpu_torch.models.heads import RECONSTRUCTED_DIR

from test_torch_support import assert_same_forest, xgb_model_dict

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
OVERLAY = REPO / "fast_monte_carlo_tpu" / "artifacts" / "reconstructed"


def _layouts(groups, numerics):
    """The same FeatureLayout in both packages."""
    kw = dict(cat_group_names=tuple(g for g, _ in groups),
              cat_group_sizes=tuple(n for _, n in groups), numeric_names=tuple(numerics),
              categories={g: tuple(f"{g} {i}" for i in range(n)) for g, n in groups})
    return tforest.FeatureLayout(**kw), jforest.FeatureLayout(**kw)


# ---- XGBoost JSON and UBJSON ---------------------------------------------------

def _ubj(v) -> bytes:
    """A UBJSON encoder for the test: typed, counted arrays for lists of
    numbers (f32 'd' for floats), plain containers otherwise."""
    if isinstance(v, dict):
        return b"{" + b"".join(_ubj_key(k) + _ubj(x) for k, x in v.items()) + b"}"
    if isinstance(v, bool):
        return b"T" if v else b"F"
    if isinstance(v, int):
        return b"l" + struct.pack(">i", v)
    if isinstance(v, float):
        return b"D" + struct.pack(">d", v)
    if isinstance(v, str):
        b = v.encode()
        return b"S" + b"U" + bytes([len(b)]) + b if len(b) < 256 else \
            b"S" + b"l" + struct.pack(">i", len(b)) + b
    if isinstance(v, list):
        if v and all(isinstance(x, float) for x in v):
            return b"[$d#l" + struct.pack(">i", len(v)) + struct.pack(f">{len(v)}f", *v)
        if v and all(isinstance(x, int) and not isinstance(x, bool) for x in v):
            return b"[$l#l" + struct.pack(">i", len(v)) + struct.pack(f">{len(v)}i", *v)
        return b"[" + b"N".join(_ubj(x) for x in v) + b"]"
    if v is None:
        return b"Z"
    raise TypeError(type(v))


def _ubj_key(k: str) -> bytes:
    b = k.encode()
    return b"U" + bytes([len(b)]) + b


XGB_CASES = {
    "binary": dict(objective="binary:logistic", n_classes=0, groups=(("passer_name", 6),),
                   base_score=0.62),
    "softprob": dict(objective="multi:softprob", n_classes=3,
                     groups=(("passer_name", 4), ("target_name", 5)), base_score=0.5),
    "identity": dict(objective="reg:squarederror", n_classes=0, groups=(), base_score=1.5),
}


@pytest.mark.parametrize("case", sorted(XGB_CASES))
@pytest.mark.parametrize("num_trees", [None, 2])
@pytest.mark.parametrize("zero_as_missing", [True, False])
def test_xgb_json_forest_equals_jax(tmp_path, case, num_trees, zero_as_missing):
    c = XGB_CASES[case]
    numerics = ("down", "distance", "yardsToGoal", "score_diff", "seconds_remaining")
    tl, jl = _layouts(c["groups"], numerics)
    model = xgb_model_dict(np.random.default_rng(len(case)), tl.n_features,
                           objective=c["objective"], n_classes=c["n_classes"],
                           base_score=c["base_score"], cat_cols=tl.n_cat, rounds=5)
    path = tmp_path / "m.json"
    path.write_text(json.dumps(model))
    got = txgb.forest_from_xgb_json(txgb.load_xgb_json(path), tl, name=case,
                                    num_trees=num_trees, zero_as_missing=zero_as_missing)
    want = jxgb.forest_from_xgb_json(jxgb.load_xgb_json(path), jl, name=case,
                                     num_trees=num_trees, zero_as_missing=zero_as_missing)
    assert_same_forest(got, want)
    assert got.n_trees == (num_trees or 5) * max(1, c["n_classes"])


@pytest.mark.parametrize("case", sorted(XGB_CASES))
@pytest.mark.parametrize("wrap", [False, True])
def test_xgb_ubj_and_json_bytes_equal_jax(case, wrap):
    """loads_auto on UBJSON bytes and on JSON bytes, and forest_from_xgb_raw
    (a pickled estimator's raw nests the booster under "Model")."""
    c = XGB_CASES[case]
    tl, jl = _layouts(c["groups"], ("down", "distance", "yardsToGoal"))
    model = xgb_model_dict(np.random.default_rng(7), tl.n_features, objective=c["objective"],
                           n_classes=c["n_classes"], cat_cols=tl.n_cat)
    if wrap:
        model = {"Model": model}
    raws = (_ubj(model), json.dumps(model).encode())
    for raw in raws:
        assert txgb.loads_auto(raw) == jxgb.loads_auto(raw)
        assert_same_forest(txgb.forest_from_xgb_raw(raw, tl, name=case, num_trees=3),
                           jxgb.forest_from_xgb_raw(raw, jl, name=case, num_trees=3))
    assert_same_forest(txgb.forest_from_xgb_raw(raws[0], tl),
                       txgb.forest_from_xgb_raw(raws[1], tl))


def test_xgb_json_refusals_equal_jax():
    """Native categorical splits raise NotImplementedError and a layout of
    another width raises ValueError, with the JAX package's messages; the
    base margins agree for every objective."""
    tl, jl = _layouts((("passer_name", 3),), ("down",))
    model = xgb_model_dict(np.random.default_rng(3), tl.n_features, cat_cols=tl.n_cat)
    model["learner"]["gradient_booster"]["model"]["trees"][1]["split_type"][0] = 1
    for fn, lay in ((txgb.forest_from_xgb_json, tl), (jxgb.forest_from_xgb_json, jl)):
        with pytest.raises(NotImplementedError, match="categorical"):
            fn(model, lay)
    wide_t, wide_j = _layouts((("passer_name", 4),), ("down",))
    with pytest.raises(ValueError) as want:
        jxgb.forest_from_xgb_json(xgb_model_dict(np.random.default_rng(3), 4), wide_j, name="w")
    with pytest.raises(ValueError) as got:
        txgb.forest_from_xgb_json(xgb_model_dict(np.random.default_rng(3), 4), wide_t, name="w")
    assert str(got.value) == str(want.value)
    for obj, base, n in (("binary:logistic", 0.62, 1), ("binary:logistic", 0.0, 1),
                         ("multi:softprob", 0.5, 5), ("reg:squarederror", -1.25, 1)):
        got, want = txgb._base_margin(obj, base, n), jxgb._base_margin(obj, base, n)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


# ---- joblib files of sklearn objects ---------------------------------------------

GROUPS = {"passer_name": 30, "target_name": 40, "rusher_name": 25}


def _plays(n=400, seed=0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({f: rng.uniform(0, 10, n).round(1) for f in P.NUM_FEATURES})
    for g, k in GROUPS.items():
        df[g] = [f"{g} {i}" for i in rng.integers(0, k, n)]
    df["yardsGained"] = rng.normal(5, 8, n) + (df["passer_name"] == "passer_name 3") * 6
    df["pass_outcome"] = np.asarray(["complete", "incomplete", "intercepted", "sack"],
                                    dtype=object)[rng.integers(0, 4, n)]
    return df


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Heads trained by the JAX package's recipes in a temporary directory:
    the pass and run quantile trios (20 trees), stage 2 (its sklearn
    fallback) and a fitted one-hot preprocessor."""
    d = tmp_path_factory.mktemp("trained")
    df = _plays()
    paths = {}
    for kind in ("pass", "run"):
        for p in P.train_quantile_heads(df, kind, d, n_estimators=20):
            paths[p.stem] = p
    paths["stage2"] = P.train_stage2(df, d)
    pre = P._ohe_pre(["passer_name", "target_name"], P.NUM_FEATURES)
    pre.fit(df[P.NUM_FEATURES + ["passer_name", "target_name"]])
    joblib.dump(pre, d / "pre.joblib")
    paths["pre"] = d / "pre.joblib"
    return paths


def _gbr_pair(path):
    return (tgbr.forest_from_gbr_pipeline(tcompat.load_sklearn_artifact(path), name="q"),
            jgbr.forest_from_gbr_pipeline(jcompat.load_sklearn_artifact(path), name="q"))


@pytest.mark.parametrize("stem", ["pass_yards_q10", "pass_yards_q50", "pass_yards_q90",
                                  "run_yards_q10", "run_yards_q90"])
def test_quantile_heads_read_as_jax(trained, stem):
    got, want = _gbr_pair(trained[stem])
    assert_same_forest(got, want)
    assert got.n_trees == 20 and got.layout.n_cat > 0
    assert_same_forest(tgbr.load_gbr_forest(trained[stem]), jgbr.load_gbr_forest(trained[stem]))


def test_stage2_and_preprocessor_read_as_jax(trained):
    got = tgbr.forest_from_gbc_pipeline(tcompat.load_sklearn_artifact(trained["stage2"]),
                                        name="stage2")
    want = jgbr.forest_from_gbc_pipeline(jcompat.load_sklearn_artifact(trained["stage2"]),
                                         name="stage2")
    assert_same_forest(got, want)
    assert got.n_classes == 3 and got.link == "softmax"
    tl = tgbr.layout_from_column_transformer(tcompat.load_sklearn_artifact(trained["pre"]))
    jl = jgbr.layout_from_column_transformer(jcompat.load_sklearn_artifact(trained["pre"]))
    assert (tl.cat_group_names, tl.cat_group_sizes, tl.numeric_names, tl.categories) == \
        (jl.cat_group_names, jl.cat_group_sizes, jl.numeric_names, jl.categories)
    assert tl.cat_group_sizes == (30, 40)


def test_committed_overlay_reads_as_jax():
    """The reconstructed overlay (sklearn 1.9's pickle, read in place)."""
    assert RECONSTRUCTED_DIR == OVERLAY
    path = OVERLAY / "pass_stage2_sklearn.joblib"
    obj = tcompat.load_sklearn_artifact(path)
    assert type(obj).__name__ == "Pipeline" and obj.standin_of == "sklearn.pipeline.Pipeline"
    assert_same_forest(tgbr.forest_from_gbc_pipeline(obj, name="stage2"),
                       jgbr.forest_from_gbc_pipeline(jcompat.load_sklearn_artifact(path),
                                                     name="stage2"))


@pytest.mark.parametrize("compress", [("zlib", 3), ("gzip", 3), ("bz2", 3), ("lzma", 3),
                                      ("xz", 3), 0])
def test_compressed_files_read_as_the_uncompressed_one(trained, tmp_path, compress):
    """joblib's whole-file compression undone by the stdlib codecs: the same
    forest as the JAX package compiles from the uncompressed file (which
    is all its reader opens)."""
    path = tmp_path / "q.joblib"
    joblib.dump(joblib.load(trained["pass_yards_q50"]), path, compress=compress)
    got = tgbr.forest_from_gbr_pipeline(tcompat.load_sklearn_artifact(path), name="q")
    assert_same_forest(got, _gbr_pair(trained["pass_yards_q50"])[1])


def test_lz4_and_truncated_files_raise(trained, tmp_path):
    lz4 = tmp_path / "a.joblib"
    lz4.write_bytes(b"\x04\x22\x4d\x18" + b"\0" * 32)
    with pytest.raises(ValueError, match="lz4"):
        tcompat.load_sklearn_artifact(lz4)
    cut = tmp_path / "cut.joblib"
    cut.write_bytes(Path(trained["pre"]).read_bytes()[:-100])
    with pytest.raises((ValueError, EOFError, pickle.UnpicklingError)):
        tcompat.load_sklearn_artifact(cut)


ROUND_TRIPS = {
    "f_order": np.asfortranarray(np.arange(24, dtype=np.float64).reshape(4, 6)),
    "zero_d": np.array(3.5),
    "empty": np.zeros((0, 3), np.int32),
    "int8": np.arange(-5, 5, dtype=np.int8),
    "big_endian": np.arange(7, dtype=">f8"),
    "bools": np.array([True, False, True]),
    "unicode": np.array(["alpha", "be"]),
    "objects": np.array(["pass", 3, None], dtype=object),
    "structured": np.zeros(3, dtype=[("left_child", "<i8"), ("threshold", "<f8"),
                                     ("missing_go_to_left", "u1")]),
    "nested": {"a": [np.arange(3), (np.ones(2, np.float32), "x")], "b": np.float64(2.5),
               "s": slice(1, 5), "c": 1 + 2j, "f": frozenset({1})},
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_joblib_arrays_round_trip(tmp_path, name):
    """Arrays as joblib writes them (aligned raw bytes, object arrays as a
    nested pickle) read back as the JAX package's reader reads them, dtype
    (byte order kept) and memory order included."""
    path = tmp_path / "x.joblib"
    joblib.dump(ROUND_TRIPS[name], path)
    got, want = tcompat.load_sklearn_artifact(path), jcompat.load_sklearn_artifact(path)

    def same(a, b):
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
            assert a.flags.f_contiguous == b.flags.f_contiguous
            assert a.tolist() == b.tolist()
        elif isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a == b and type(a) is type(b)
    same(got, want)


def test_plain_pickles_read_as_jax(tmp_path):
    """Plain pickles (feature lists, label encoders, protocols 2 to 5, an
    array under the numpy.core name sklearn 1.3-era files carry) read as
    the JAX package's reader reads them."""
    objs = [list(P.NUM_FEATURES) + ["head_coach"],
            np.asarray(["field_goal", "pass", "punt", "run", "timeout"], dtype=object),
            np.asarray(["a", "bb"]), np.arange(4.0)]
    for i, obj in enumerate(objs):
        for proto in (2, 4, 5):
            path = tmp_path / f"p{i}_{proto}.pkl"
            raw = pickle.dumps(obj, protocol=proto)
            if proto == 2:
                raw = raw.replace(b"numpy._core.multiarray", b"numpy.core.multiarray")
            path.write_bytes(raw)
            got, want = tcompat.load_plain_pickle(path), jcompat.load_plain_pickle(path)
            assert np.asarray(got).tolist() == np.asarray(want).tolist()
            assert np.asarray(got).dtype == np.asarray(want).dtype


def test_joblib_written_label_encoder_reads_where_jax_cannot(tmp_path):
    """A label encoder written by joblib.dump (as train_play_policy writes
    label_encoder.pkl): the JAX package's plain reader cannot read its
    array (ROADMAP.md queue 3); the port's reads it."""
    path = tmp_path / "label_encoder.pkl"
    classes = np.asarray(["pass", "run"], dtype=object)
    joblib.dump(classes, path)
    with pytest.raises(pickle.UnpicklingError):
        jcompat.load_plain_pickle(path)
    assert tcompat.load_plain_pickle(path).tolist() == classes.tolist()


class _Evil:
    def __init__(self, fn, arg):
        self.fn, self.arg = fn, arg

    def __reduce__(self):
        return (self.fn, (self.arg,))


@pytest.mark.parametrize("fn,arg", [(os.system, "true"), (eval, "1"),
                                    (subprocess.getoutput, "true")])
def test_globals_outside_the_allow_list_raise(tmp_path, fn, arg):
    path = tmp_path / "evil.joblib"
    path.write_bytes(pickle.dumps({"model": _Evil(fn, arg)}))
    for load in (tcompat.load_sklearn_artifact, tcompat.load_plain_pickle,
                 tcompat.extract_xgb_pickle_raw):
        with pytest.raises(ValueError, match=f"global .*{fn.__name__}"):
            load(path)


def test_pickled_xgboost_estimator_raw_equals_jax(tmp_path, monkeypatch):
    """extract_xgb_pickle_raw: an estimator pickled from classes of the
    xgboost modules (made here; xgboost is not installed) holds its booster
    as bytes; both readers find the same bytes, and the forest they give
    is the JAX package's."""
    sk, core = types.ModuleType("xgboost.sklearn"), types.ModuleType("xgboost.core")
    for m in (sk, core):
        monkeypatch.setitem(sys.modules, m.__name__, m)
    monkeypatch.setitem(sys.modules, "xgboost", types.ModuleType("xgboost"))
    Booster = type("Booster", (), {"__module__": "xgboost.core"})
    XGBClassifier = type("XGBClassifier", (), {"__module__": "xgboost.sklearn"})
    core.Booster, sk.XGBClassifier = Booster, XGBClassifier
    tl, jl = _layouts((("head_coach", 6),), ("down", "distance"))
    model = xgb_model_dict(np.random.default_rng(5), tl.n_features, objective="multi:softprob",
                           n_classes=5, cat_cols=tl.n_cat)
    bst, est = Booster(), XGBClassifier()
    bst.handle = bytearray(_ubj({"Model": model}))
    est.__dict__.update(n_estimators=4, _Booster=bst, classes_=np.arange(5))
    path = tmp_path / "play_model.xgb"
    path.write_bytes(pickle.dumps(est))
    got, want = tcompat.extract_xgb_pickle_raw(path), jcompat.extract_xgb_pickle_raw(path)
    assert got == want == bytes(bst.handle)
    assert_same_forest(txgb.forest_from_xgb_raw(got, tl), jxgb.forest_from_xgb_raw(want, jl))


def test_reader_loads_every_committed_file_without_sklearn_or_joblib():
    """In a process where sklearn, joblib and pandas cannot be imported,
    every committed joblib and pickle file loads, and so do the fixture
    heads and the overlay."""
    code = (
        "import sys\n"
        "for m in ('sklearn', 'joblib', 'pandas', 'xgboost'):\n"
        "    sys.modules[m] = None\n"
        "from pathlib import Path\n"
        "from fast_monte_carlo_tpu_torch import compat, fixtures\n"
        "from fast_monte_carlo_tpu_torch.models import heads\n"
        "files = sorted(Path(fixtures.ARTIFACT_DIR).glob('*.joblib')) +"
        " sorted(Path(fixtures.ARTIFACT_DIR).glob('*.pkl')) +"
        " sorted(heads.RECONSTRUCTED_DIR.glob('*.joblib'))\n"
        "for p in files:\n"
        "    compat.load_sklearn_artifact(p)\n"
        "h = heads.load_heads(fixtures.ARTIFACT_DIR)\n"
        "r = heads.load_reconstructed_heads(fixtures.ARTIFACT_DIR)\n"
        "assert h.stage1 is not None and r.stage2 is not r and r.play_temperature == 1.45\n"
        "bad = [m for m in ('sklearn', 'joblib', 'pandas', 'jax', 'fast_monte_carlo_tpu')"
        " if sys.modules.get(m) is not None]\n"
        "assert not bad, bad\n"
        "print(len(files))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == 16       # 12 joblib and 3 pickles of the fixture, 1 overlay
