"""Generate tests/data/torch_artifacts/: a trained-head artifact directory in
the reference's file layout, for the PyTorch port's loaders and the routes
built on them.

Run from the repository root on a host with the JAX package's training
dependencies (pandas, scikit-learn, joblib; xgboost is not needed):

    python tests/data/make_torch_artifacts.py

Seeded; it writes every file kind that `models.heads.load_heads` reads:

* the nine quantile heads ``{pass,run,sack}_yards_q{10,50,90}.joblib`` from
  the JAX package's own recipe (`train.pipeline.train_quantile_heads`: 400
  trees of depth 3) on seeded synthetic plays whose player columns draw from
  563 passers, 900 targets and 700 rushers (the reference's one-hot widths),
  re-written with ``compress=("zlib", 3)``;
* ``pass_stage2_sklearn.joblib`` and ``pass_stage2_classes.csv`` from
  `train.pipeline.train_stage2` (its sklearn fallback, early-stopped);
* ``pass_stage1_complete_vs_not.json`` + ``pass_stage1_preprocessor.joblib``
  and ``run_fumble.json`` + ``run_fumble_preprocessor.joblib``: preprocessors
  fitted by the recipe's `_ohe_pre`, and seeded trees in XGBoost's JSON
  schema over their column space (there is no xgboost here), with the
  reference-shape heads' tree counts and depths
  (`fast_monte_carlo_tpu_torch.fixtures.HEAD_SHAPES["reference"]`);
* ``play_model.json`` (seeded 5-class trees over the reference's legacy
  layout: 12 numerics and 168 head-coach dummies), ``features.pkl``,
  ``label_encoder.pkl``, ``coach_label_encoder.pkl`` (plain pickles) and
  ``calibration.json``, as `train.pipeline.train_play_policy` names them.

Every joblib file but the quantile heads is uncompressed.  The trees are
random where they are seeded (they drive the loaders, exact mode and the
table build at the trained heads' shapes, not a trained model's numbers).
"""
import json
import pickle
import shutil
import sys
import tempfile
from pathlib import Path

import joblib
import numpy as np
import pandas as pd

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from fast_monte_carlo_tpu.train import pipeline as P  # noqa: E402
from fast_monte_carlo_tpu_torch import fixtures  # noqa: E402
from fast_monte_carlo_tpu_torch.matchup import DEFAULT_HEAD_COACH_MAP  # noqa: E402

OUT = REPO / "tests" / "data" / "torch_artifacts"
SEED = 20251
N_PLAYS = 6000
GROUP_WIDTHS = {"passer_name": 563, "target_name": 900, "rusher_name": 700}
ROLE_OF = {"passer_name": "pass", "target_name": "rec", "rusher_name": "rush"}
N_COACHES = 168                     # the reference play model's dummies (180 - 12)
PLAY_CLASSES = ("field_goal", "pass", "punt", "run", "timeout")
PLAY_TEMPERATURE = 1.3


def group_names(group: str) -> list:
    """"Unknown", the fixture teams' players of the group's role, then
    fillers up to the group's width."""
    role = ROLE_OF[group]
    n = {"pass": 2, "rec": 5, "rush": 3}[role]
    hot = ["Unknown"] + [fixtures.roster_name(t, role, i)
                         for t in (fixtures.TEAM_A[0], fixtures.TEAM_B[0]) for i in range(n)]
    hot = list(dict.fromkeys(hot))
    label = group.split("_")[0].title()
    return hot + [f"{label} {i:03d}" for i in range(GROUP_WIDTHS[group] - len(hot))]


def synthetic_plays(rng: np.random.Generator) -> pd.DataFrame:
    """N_PLAYS seeded play rows: the 17 state features, the three player
    columns (every name of each group appears), yards by kind and a pass
    outcome."""
    n = N_PLAYS
    down = rng.integers(1, 5, n)
    dist = np.round(rng.uniform(1, 20, n) * 2) / 2
    ytg = rng.integers(1, 100, n).astype(float)
    sec = rng.integers(0, 3601, n).astype(float)
    df = pd.DataFrame({
        "down": down.astype(float), "distance": dist, "yardsToGoal": ytg,
        "is_red_zone": (ytg <= 20).astype(float),
        "score_diff": rng.integers(-28, 29, n).astype(float),
        "seconds_remaining": sec,
        "offenseTimeouts": rng.integers(0, 4, n).astype(float),
        "defenseTimeouts": rng.integers(0, 4, n).astype(float),
        "sp_rating_off": np.round(rng.uniform(-10, 30, n), 1),
        "sp_offense_rating_off": np.round(rng.uniform(15, 45, n), 1),
        "sp_defense_rating_def": np.round(rng.uniform(10, 35, n), 1),
        "sp_rating_def": np.round(rng.uniform(-10, 30, n), 1),
        "goal_to_go": (dist >= ytg).astype(float),
        "fourth_and_short": ((down == 4) & (dist <= 2)).astype(float),
        "fg_range": (ytg <= 35).astype(float),
        "half": np.where(sec > 1800, 1.0, 2.0),
        "two_minute": (((sec > 1800) & (sec <= 1920)) | (sec <= 120)).astype(float),
    })
    effects = {}
    for g in GROUP_WIDTHS:
        names = group_names(g)
        idx = np.concatenate([np.arange(len(names)),
                              rng.integers(0, len(names), n - len(names))])
        rng.shuffle(idx)
        df[g] = np.asarray(names, dtype=object)[idx]
        eff = rng.normal(0.0, 1.0, len(names))
        eff[1:12] = rng.normal(0.0, 2.0, 11)      # the rosters' players stand out
        eff[0] = 0.0                              # "Unknown"
        effects[g] = eff[idx]
    base = (0.08 * (df["yardsToGoal"] - 50) + 0.3 * df["distance"]
            + 0.1 * df["sp_offense_rating_off"] - 0.1 * df["sp_defense_rating_def"])
    df["pass_yards"] = base + 3 + effects["passer_name"] + effects["target_name"] \
        + rng.gumbel(0, 5, n)
    df["run_yards"] = 0.5 * base + 1.5 + effects["rusher_name"] + rng.gumbel(0, 3.5, n)
    df["sack_yards"] = -6 - 0.5 * effects["passer_name"] + rng.normal(0, 2, n)
    z = np.stack([0.3 * effects["passer_name"] - 0.05 * df["distance"],
                  np.zeros(n), -2.3 + 0.1 * (df["down"] == 3), -1.7 + 0.02 * df["distance"]], 1)
    p = np.exp(z) / np.exp(z).sum(1, keepdims=True)
    u = rng.random(n)[:, None]
    df["pass_outcome"] = np.asarray(["complete", "incomplete", "intercepted", "sack"],
                                    dtype=object)[(u > p.cumsum(1)).sum(1)]
    return df


def xgb_tree(rng, tid: int, n_cat: int, hot: list, numerics: list, levels: int,
             p_split: float, leaf_sd: float, dummy_cond: float) -> dict:
    """One tree in XGBoost's JSON schema over columns [`n_cat` one-hot
    columns, then `numerics`]: a split one time in six on a one-hot
    column (a roster player's four times in five, `hot` global columns),
    else on a numeric at a threshold from the fixtures' feature ranges."""
    t = {k: [] for k in ("left_children", "right_children", "split_indices",
                         "split_conditions", "default_left", "split_type", "parents")}

    def node(level: int, parent: int) -> int:
        i = len(t["left_children"])
        for k in t:
            t[k].append(0)
        t["parents"][i] = parent if parent >= 0 else 2147483647
        if level == levels - 1 or (level > 0 and rng.random() >= p_split):
            t["left_children"][i] = t["right_children"][i] = -1
            t["split_conditions"][i] = float(np.float32(rng.normal(0.0, leaf_sd)))
            return i
        if n_cat and rng.random() < 1 / 6:
            col = int(rng.choice(hot)) if rng.random() < 0.8 else int(rng.integers(n_cat))
            t["split_indices"][i] = col
            t["split_conditions"][i] = dummy_cond
        else:
            j = int(rng.integers(len(numerics)))
            t["split_indices"][i] = n_cat + j
            t["split_conditions"][i] = float(np.float32(fixtures._threshold(rng, numerics[j])))
        t["default_left"][i] = int(rng.random() < 0.5)
        t["left_children"][i] = node(level + 1, i)
        t["right_children"][i] = node(level + 1, i)
        return i

    node(0, -1)
    t["id"] = tid
    t["tree_param"] = {"num_deleted": "0", "num_feature": str(n_cat + len(numerics)),
                       "num_nodes": str(len(t["left_children"])), "size_leaf_vector": "1"}
    return t


def xgb_model(trees: list, objective: str, num_class: int, base_score: float,
              num_feature: int) -> dict:
    n_per = max(1, num_class)
    return {"learner": {
        "attributes": {},
        "feature_names": [], "feature_types": [],
        "gradient_booster": {
            "model": {"gbtree_model_param": {"num_parallel_tree": "1",
                                             "num_trees": str(len(trees))},
                      "iteration_indptr": list(range(0, len(trees) + 1, n_per)),
                      "tree_info": [i % n_per for i in range(len(trees))],
                      "trees": trees},
            "name": "gbtree"},
        "learner_model_param": {"base_score": f"{base_score:.7E}", "boost_from_average": "1",
                                "num_class": str(num_class), "num_feature": str(num_feature),
                                "num_target": "1"},
        "objective": {"name": objective}},
        "version": [2, 0, 3]}


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, separators=(",", ":")))


def binary_head(rng, df, group: str, stem: str, model_name: str, shape_key: str,
                base_score: float, leaf_sd: float) -> None:
    """A fitted one-hot preprocessor and seeded binary:logistic trees over
    its columns."""
    pre = P._ohe_pre([group], P.NUM_FEATURES)
    X = df[P.NUM_FEATURES + [group]].copy()
    pre.fit(X)
    joblib.dump(pre, OUT / f"{stem}_preprocessor.joblib")
    cats = [str(c) for c in pre.named_transformers_["cat"].categories_[0]]
    hot = [cats.index(n) for n in group_names(group)[:12]]
    n_trees, levels = fixtures.HEAD_SHAPES["reference"][shape_key]
    trees = [xgb_tree(rng, i, len(cats), hot, P.NUM_FEATURES, levels, 0.8,
                      leaf_sd, 1.0) for i in range(n_trees)]
    write_json(OUT / model_name,
               xgb_model(trees, "binary:logistic", 0, base_score, len(cats) + 17))


def play_head(rng) -> None:
    coaches = sorted(set(DEFAULT_HEAD_COACH_MAP.values()) | set(fixtures.COACH_MAP.values()))
    coaches = sorted(coaches + [f"Coach {i:03d}" for i in range(N_COACHES - len(coaches))])
    numerics = list(P.NUM_FEATURES[:12])
    n_trees, levels = fixtures.HEAD_SHAPES["reference"]["play"]
    # the legacy layout: 12 numerics first, then one dummy a coach
    hot = [len(numerics) + coaches.index(c) for c in fixtures.COACH_MAP.values()]
    trees = []
    for i in range(n_trees):
        t = xgb_tree(rng, i, 0, [], numerics, levels, 0.8, 0.05, 0.5)
        for k, s in enumerate(t["split_indices"]):   # a split in six on a coach dummy
            if t["left_children"][k] != -1 and rng.random() < 1 / 6:
                t["split_indices"][k] = int(rng.choice(hot)) if rng.random() < 0.8 else \
                    len(numerics) + int(rng.integers(N_COACHES))
                t["split_conditions"][k] = 0.5
        t["tree_param"]["num_feature"] = str(len(numerics) + N_COACHES)
        trees.append(t)
    write_json(OUT / "play_model.json", xgb_model(trees, "multi:softprob", len(PLAY_CLASSES),
                                                  0.5, len(numerics) + N_COACHES))
    with open(OUT / "features.pkl", "wb") as f:
        pickle.dump(list(P.NUM_FEATURES + ["head_coach"]), f)
    with open(OUT / "label_encoder.pkl", "wb") as f:
        pickle.dump(np.asarray(PLAY_CLASSES, dtype=object), f)
    with open(OUT / "coach_label_encoder.pkl", "wb") as f:
        pickle.dump(np.asarray(coaches, dtype=object), f)
    (OUT / "calibration.json").write_text(json.dumps({"temperature": PLAY_TEMPERATURE}))


def main() -> None:
    rng = np.random.default_rng(SEED)
    df = synthetic_plays(rng)
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("pass", "run", "sack"):
            plays = df.assign(yardsGained=df[f"{kind}_yards"])
            for p in P.train_quantile_heads(plays, kind, tmp):
                joblib.dump(joblib.load(p), OUT / p.name, compress=("zlib", 3))
        P.train_stage2(df, tmp)
        for name in ("pass_stage2_sklearn.joblib", "pass_stage2_classes.csv"):
            shutil.copy(Path(tmp) / name, OUT / name)
    binary_head(rng, df, "passer_name", "pass_stage1", "pass_stage1_complete_vs_not.json",
                "stage1", 0.62, 0.03)
    binary_head(rng, df, "rusher_name", "run_fumble", "run_fumble.json", "fumble", 0.012, 0.02)
    play_head(rng)
    total = 0
    for p in sorted(OUT.iterdir()):
        total += p.stat().st_size
        print(f"{p.name:40s} {p.stat().st_size:>10,d}")
    print(f"{'total':40s} {total:>10,d}")


if __name__ == "__main__":
    main()
