"""Shared helpers for the PyTorch-port tests, and checks of the fixtures.

Inputs are made from numpy seeds and handed to both packages as numpy
arrays: the JAX package (the reference, on the CPU) and its PyTorch port
`fast_monte_carlo_tpu_torch` (here on the CPU, where each kernel wrapper
runs its plain PyTorch version)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
from fast_monte_carlo_tpu.config import resolve_nano_select
from fast_monte_carlo_tpu.data.context import _build
from fast_monte_carlo_tpu.data.usage import build_focus_usage_tables
from fast_monte_carlo_tpu.models import tables as jt
from fast_monte_carlo_tpu.models.heads import ModelHeads
from fast_monte_carlo_tpu.ops import game as jg
from fast_monte_carlo_tpu.ops import table_lookup as jtl
from fast_monte_carlo_tpu.ops.pack import build_packs
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.models.tables import FUSED_CHANNELS, nano_profile
from fast_monte_carlo_tpu_torch.ops import game as tg
from fast_monte_carlo_tpu_torch.ops import table_lookup as ttl
from fast_monte_carlo_tpu_torch.ops.pack import matchup_pack_from_numpy

torch.set_num_threads(1)

TABLE_SEED = 7


@pytest.fixture(autouse=True, scope="module")
def table_cache_off():
    """The port's table disk cache off (`ops.table_lookup.TABLE_CACHE_DIR`
    None) for the test module: its tables are built, as before the cache,
    and nothing is written into the checkout.  The cache's own tests pass
    a directory (`cache_dir=`, or TABLE_CACHE_DIR on a `tmp_path`).
    Autouse in every test module that imports it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ttl, "TABLE_CACHE_DIR", None)
    yield
    mp.undo()


FOCUS_SEED = 3
REPO = Path(__file__).resolve().parents[1]


def run_ranks(code: str, world: int, tmp_path, timeout: float = 150) -> list:
    """`code` run by `world` child processes on the CPU, rank RANK of WORLD
    in a gloo group that meets through a FileStore under `tmp_path` (no TCP
    port to collide on between test workers; gloo's own links stay on the
    loopback interface).  The children import the port only, never this
    module.  Returns each rank's stdout; raises with every rank's output if
    one fails or the ranks outlast `timeout`."""
    pre = ("import sys, torch\n"
           "torch.set_num_threads(1)\n"
           f"sys.path.insert(0, {str(REPO)!r})\n"
           "import torch.distributed as dist\n"
           f"RANK, WORLD = int(sys.argv[1]), {world}\n"
           f"STORE = dist.FileStore({str(tmp_path / 'store')!r}, WORLD)\n"
           "dist.init_process_group('gloo', store=STORE, rank=RANK, world_size=WORLD)\n")
    # every rank done with every collective before any tears the group
    # down (a gloo peer torn down while the other still runs has aborted
    # at exit); the store, not a collective, says so, since a rank leaving
    # a barrier does not mean its peer has left it too
    post = ("\nSTORE.set(f'done{RANK}', '1')\n"
            "STORE.wait([f'done{r}' for r in range(WORLD)])\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, "-c", pre + code + post, str(r)], cwd=tmp_path,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs += [p.communicate() for p in procs[len(outs):]]
        raise AssertionError(f"ranks outlasted {timeout} s: {outs}")
    if any(p.returncode for p in procs):
        raise AssertionError("a rank failed: " + "\n".join(
            f"rank {r} rc {p.returncode}:\n{o}\n{e[-3000:]}"
            for r, (p, (o, e)) in enumerate(zip(procs, outs))))
    return [o for o, _ in outs]


def jax_teams(k: int = 8, focus_csv=None):
    """The fixture teams through the JAX package's own `_build`, with the
    rosters of the focus sheet at `focus_csv` if given."""
    focus = build_focus_usage_tables(str(focus_csv)) if focus_csv else {}
    return (_build(*fixtures.TEAM_A, focus, ".", k),
            _build(*fixtures.TEAM_B, focus, ".", k))


def write_focus(path, seed: int = FOCUS_SEED):
    """`fixtures.focus_rows(seed)` written as a focus sheet at `path`."""
    fixtures.write_csv(path, fixtures.focus_rows(seed), fixtures.FOCUS_COLS)
    return path


def jax_pack(cfg=None, k: int = 8, focus_csv=None):
    a, b = jax_teams(k, focus_csv)
    return build_packs(a, b, ModelHeads(), cfg or JaxSimConfig())[0]


def pack_arrays(jpack) -> dict:
    return {f.name: np.asarray(getattr(jpack, f.name))
            for f in dataclasses.fields(jpack)}


def port_pack(jpack, device="cpu"):
    return matchup_pack_from_numpy(pack_arrays(jpack), device)


def jax_host(t) -> "jt.HostTable":
    """A port HostTable (fused layout) as the JAX package's HostTable."""
    return jt.HostTable(values=t.values, shape=t.shape, row_map=t.row_map,
                        profile=t.profile, has_sd=t.has_sd,
                        channels=t.channels)


def jax_table_heads(seed: int = TABLE_SEED):
    """The fixture's fused grids, re-laid out and packed by the JAX
    package (TableSet(..., nano=...) -> pack_tables)."""
    prof = jt.nano_profile()
    sets = []
    for t in fixtures.fused_tables(seed):
        sets.append(jt.TableSet(
            stage1=None, stage2=None, pq=None, rq=None, sq=None, fumble=None,
            play=None, fine=jt.fine_profile(), coarse=jt.coarse_profile(),
            nano=jt.nano_from_fused(jax_host(t), prof)))
    return jtl.pack_tables(sets[0], sets[1], k=8, nano_prof=prof)


def heads_pair(mode: str):
    """(jax heads_eval, jax heads_state, port heads_eval, port heads_state)
    for "analytic" or "table" (the fixture's nano table) heads."""
    if mode == "analytic":
        return (jg.make_analytic_heads_eval(JaxSimConfig()), None,
                tg.make_analytic_heads_eval(SimConfig()), None)
    jcfg = resolve_nano_select(JaxSimConfig(), collect_stats=False)
    return (jtl.make_table_heads_eval(jcfg), jax_table_heads(),
            ttl.make_table_heads_eval(SimConfig()),
            ttl.pack_tables(*fixtures.nano_tables(TABLE_SEED), device="cpu"))


def jax_state(d: dict) -> "jg.GameState":
    """`fixtures.play_states` rows as a JAX GameState; its stats and pstats
    are the rows' (nonzero with `k`, else the 1-element dummies)."""
    return jg.GameState(**{k: jnp.asarray(v) for k, v in d.items()})


def port_state(d: dict, device="cpu") -> "tg.GameState":
    """The same rows as a port GameState, each field a copy."""
    return tg.GameState(**{k: torch.tensor(v, device=device) for k, v in d.items()})


INT_FIELDS = ("off", "sec", "down", "period", "in_rz", "going", "score")
FLOAT_FIELDS = ("dist", "ytg")


def row_mismatch(jax_out, port_out) -> np.ndarray:
    """(B,) bool: rows whose integer fields differ between the packages."""
    bad = None
    for f in INT_FIELDS:
        x = np.asarray(getattr(jax_out, f))
        y = getattr(port_out, f).cpu().numpy()
        m = x != y
        m = m.any(axis=1) if m.ndim > 1 else m
        bad = m if bad is None else bad | m
    return bad


NUDGE = 1e-4


def flips_back(d, i, u, z, want, pack, he, hs, cfg=None) -> bool:
    """Does row i reach the JAX outcome `want` (integer fields) when one of
    its 17 draws moves by +-NUDGE, under `cfg` (default SimConfig())?
    (True = the row sits within NUDGE of a threshold.)"""
    variants = []
    for c in range(17):
        for sgn in (-1.0, 1.0):
            uu, zz = u[i].copy(), z[i].copy()
            if c < 13:
                uu[c] = np.clip(uu[c] + sgn * NUDGE, 0.0, 1.0 - 2.0 ** -24)
            else:
                zz[c - 13] += sgn * NUDGE
            variants.append((uu, zz))
    m = len(variants)
    rows = {k: np.repeat(v[i:i + 1], m, axis=0) for k, v in d.items()}
    out = tg.play_step(port_state(rows),
                       (torch.from_numpy(np.stack([v[0] for v in variants])),
                        torch.from_numpy(np.stack([v[1] for v in variants]))),
                       pack, cfg or SimConfig(), he, hs)
    match = np.ones(m, bool)
    for f in INT_FIELDS:
        ok = getattr(out, f).numpy() == want[f]
        match &= ok.all(axis=1) if ok.ndim > 1 else ok
    return bool(match.any())


def jax_analytic_runner():
    """The JAX package's MatchupRunner on the fixture teams, analytic heads.
    scan_unroll only shapes XLA's loop (the draws key on the absolute
    step): at 1 the live programs compile in a few seconds."""
    from fast_monte_carlo_tpu.api import MatchupRunner as JaxRunner

    cfg = JaxSimConfig()
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, scan_unroll=1))
    return JaxRunner(*jax_teams(), None, cfg, mode="analytic")


def port_analytic_runner(cfg=None):
    """The port's MatchupRunner on the fixture teams, analytic heads, CPU."""
    from fast_monte_carlo_tpu_torch.api import MatchupRunner

    return MatchupRunner(*fixtures.teams(), None, cfg or SimConfig(), mode="analytic",
                         device="cpu")


def within(got: float, want: float, p: float, n: int, k: float = 4.0) -> bool:
    """|got - want| within k standard errors of the difference of two
    rates p, each over n games."""
    return abs(got - want) <= k * np.sqrt(2 * max(p * (1 - p), 1e-6) / n)


SITUATION_FIELDS = ("offense", "sec", "down", "dist", "ytg", "score_a", "score_b")


def random_situations(rng: np.random.Generator, n: int) -> dict:
    """n mid-game situations as numpy arrays keyed by Situation field,
    inside the bounds `_validated_situation` takes: clocks over the whole
    game (the last seconds of each quarter among them), every down,
    distances in half yards, fields from the 1 to the 99, scores up to 127."""
    sec = rng.integers(1, 3601, n).astype(np.int32)
    sec[: n // 10] = rng.choice([1, 899, 900, 901, 1800, 1801, 2700, 3600], n // 10)
    return dict(
        offense=rng.integers(0, 2, n).astype(np.int32), sec=sec,
        down=rng.integers(1, 5, n).astype(np.int32),
        dist=(np.round(rng.uniform(0.5, 30, n) * 2) / 2).astype(np.float32),
        ytg=rng.integers(1, 100, n).astype(np.float32),
        score_a=rng.integers(0, 128, n).astype(np.int32),
        score_b=rng.integers(0, 128, n).astype(np.int32))


def situation_from_numpy(d: dict, i=None, module=tg):
    """Row i of `random_situations` as a Situation of Python numbers, or
    (i None) all rows as one Situation of per-trial arrays: numpy arrays
    for the JAX package (module=jg), tensors for the port."""
    if i is not None:
        return module.Situation(*(d[f][i].item() for f in SITUATION_FIELDS))
    if module is tg:
        return tg.Situation(*(torch.from_numpy(d[f]) for f in SITUATION_FIELDS))
    return module.Situation(*(d[f] for f in SITUATION_FIELDS))


def test_fixture_grid_shape_and_ranges():
    a, b = fixtures.fused_tables(TABLE_SEED)
    assert a.shape + (a.channels,) == fixtures.FUSED_GRID_SHAPE
    assert a.values.dtype == np.float32 and a.has_sd
    prof = nano_profile()
    assert fixtures.FUSED_GRID_SHAPE[2:6] == (
        len(prof.dist), len(prof.ytg), len(prof.sec), len(prof.sd))
    for i, name in enumerate(FUSED_CHANNELS[:7]):
        lo, hi = fixtures.CHANNEL_RANGES[name]
        col = a.values[:, i]
        assert lo <= col.min() and col.max() <= hi, name
    assert not np.array_equal(a.values, b.values)   # a grid per direction
    again, _ = fixtures.fused_tables(TABLE_SEED)
    np.testing.assert_array_equal(a.values, again.values)


def test_random_states_are_consistent():
    d = fixtures.play_states(np.random.default_rng(0), 1000)
    assert (d["period"] == np.where(d["sec"] > 0,
                                    4 - (d["sec"] - 1) // 900, 4)).all()
    assert set(np.unique(d["down"])) == {1, 2, 3, 4}
    assert (d["sec"] == 0).any() and ((d["sec"] > 1800) & (d["sec"] < 1830)).any()
    js, ps = jax_state(d), port_state(d)
    for f in INT_FIELDS + FLOAT_FIELDS + ("stats", "pstats"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ps, f).numpy())
    assert d["stats"].shape == (1000, 1, 1) and d["pstats"].shape == (1000, 1, 1, 1, 1)
    # with k the box score and player stats start nonzero: counts whole,
    # yards in tenths; the JAX and port states carry them alike
    d = fixtures.play_states(np.random.default_rng(0), 1000, k=8)
    assert d["stats"].shape == (1000, 2, 19) and d["pstats"].shape == (1000, 2, 3, 8, 6)
    for x, yards in ((d["stats"], [3, 8]), (d["pstats"], [2])):
        assert (x != 0).mean() > 0.9
        counts = np.delete(x, yards, axis=-1)
        assert (counts == np.round(counts)).all()
        assert (np.take(x, yards, axis=-1) != np.round(np.take(x, yards, axis=-1))).any()
    js, ps = jax_state(d), port_state(d)
    for f in ("stats", "pstats"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ps, f).numpy())


def forest_arrays(f) -> dict:
    """Every field of a FlatForest of either package as the dict that
    `models.forest.flat_forest_from_numpy` takes (numpy arrays, scalars
    and the layout's names, sizes and categories)."""
    from fast_monte_carlo_tpu_torch.models.forest import FOREST_ARRAYS

    lay = f.layout
    d = {k: np.asarray(getattr(f, k)).copy() for k in FOREST_ARRAYS}
    d.update(n_classes=f.n_classes, link=f.link, cmp=f.cmp, max_depth=f.max_depth,
             name=f.name, zero_as_missing=f.zero_as_missing,
             cat_group_names=tuple(lay.cat_group_names),
             cat_group_sizes=tuple(lay.cat_group_sizes),
             numeric_names=tuple(lay.numeric_names),
             categories={g: tuple(c) for g, c in lay.categories.items()})
    return d


HEAD_FIELDS = ("stage1", "stage2", "fumble", "play")
TRIO_FIELDS = ("pass_quants", "rush_quants", "sack_quants")


def heads_arrays(h) -> dict:
    """A ModelHeads of either package as the dict that
    `models.heads.model_heads_from_numpy` takes."""
    d = {k: None if getattr(h, k) is None else forest_arrays(getattr(h, k))
         for k in HEAD_FIELDS}
    d.update({k: None if getattr(h, k) is None else [forest_arrays(f) for f in getattr(h, k)]
              for k in TRIO_FIELDS})
    d.update(stage2_class_order=tuple(h.stage2_class_order),
             play_temperature=h.play_temperature, play_classes=tuple(h.play_classes))
    return d


def jax_forest(f):
    """A FlatForest of either package as the JAX package's FlatForest."""
    from fast_monte_carlo_tpu.models.forest import FeatureLayout, FlatForest

    d = forest_arrays(f)
    lay = FeatureLayout(cat_group_names=d.pop("cat_group_names"),
                        cat_group_sizes=d.pop("cat_group_sizes"),
                        numeric_names=d.pop("numeric_names"),
                        categories=d.pop("categories"))
    return FlatForest(layout=lay, **d)


def jax_heads(h) -> ModelHeads:
    """A ModelHeads of either package (e.g. `fixtures.heads`) as the JAX
    package's ModelHeads, forest for forest."""
    kw = {k: None if getattr(h, k) is None else jax_forest(getattr(h, k)) for k in HEAD_FIELDS}
    kw.update({k: None if getattr(h, k) is None else tuple(jax_forest(f) for f in getattr(h, k))
               for k in TRIO_FIELDS})
    return ModelHeads(stage2_class_order=tuple(h.stage2_class_order),
                      play_temperature=h.play_temperature,
                      play_classes=tuple(h.play_classes), **kw)


def port_heads(h):
    """A ModelHeads of either package carried into the port's ModelHeads."""
    from fast_monte_carlo_tpu_torch.models.heads import model_heads_from_numpy

    return model_heads_from_numpy(heads_arrays(h))


def jax_readable_copy(src, dst):
    """A copy of the artifact directory `src` at `dst` that the JAX
    package's loaders read: its `load_sklearn_artifact` opens a joblib file
    as an uncompressed stream, so compressed joblib files (the fixture's
    quantile heads are zlib) are written decompressed, as joblib.load
    reads them.  Returns dst as a string."""
    import shutil
    import zlib
    from pathlib import Path

    dst = Path(dst)
    shutil.copytree(src, dst)
    for p in dst.glob("*.joblib"):
        raw = p.read_bytes()
        if raw[:1] == b"\x78":
            p.write_bytes(zlib.decompress(raw))
    return str(dst)


def xgb_model_dict(rng, n_features: int, *, objective: str = "binary:logistic",
                   n_classes: int = 0, rounds: int = 4, levels: int = 4,
                   base_score: float = 0.4, cat_cols: int = 0) -> dict:
    """A seeded XGBoost JSON model dict (the fields `forest_from_xgb_json`
    reads): `rounds` boosting rounds of one tree per class, splits to
    `levels` levels, the first `cat_cols` columns one-hot (threshold 1.0),
    the others numeric thresholds in [0, 10) on the half point."""
    per = max(1, n_classes)
    trees = []
    for t in range(rounds * per):
        tr = {k: [] for k in ("left_children", "right_children", "split_indices",
                              "split_conditions", "default_left")}

        def node(level):
            i = len(tr["left_children"])
            for k in tr:
                tr[k].append(0)
            if level == levels - 1 or (level and rng.random() < 0.25):
                tr["left_children"][i] = tr["right_children"][i] = -1
                tr["split_conditions"][i] = float(np.float32(rng.normal(0, 0.3)))
                return i
            col = int(rng.integers(n_features))
            tr["split_indices"][i] = col
            tr["split_conditions"][i] = 1.0 if col < cat_cols else \
                float(np.round(rng.uniform(0, 10) * 2) / 2)
            tr["default_left"][i] = int(rng.random() < 0.5)
            tr["left_children"][i] = node(level + 1)
            tr["right_children"][i] = node(level + 1)
            return i

        node(0)
        tr["split_type"] = [0] * len(tr["left_children"])
        trees.append(tr)
    return {"learner": {
        "objective": {"name": objective},
        "learner_model_param": {"base_score": f"{base_score:.7E}", "num_class": str(n_classes),
                                "num_feature": str(n_features)},
        "gradient_booster": {"name": "gbtree", "model": {
            "trees": trees, "tree_info": [t % per for t in range(len(trees))]}}}}


def assert_same_forest(port, jax):
    """Two FlatForests (of either package) equal field for field: every
    node array with its dtype, the scalars and the layout."""
    p, j = forest_arrays(port), forest_arrays(jax)
    assert p.keys() == j.keys()
    for k, v in j.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(p[k], v, err_msg=k)
            assert p[k].dtype == v.dtype, k
        else:
            assert p[k] == v, k


def assert_same_heads(port, jax):
    """Two ModelHeads equal: every forest (or both None), the stage-2 class
    order, the play temperature and classes."""
    for k in HEAD_FIELDS:
        a, b = getattr(port, k), getattr(jax, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert_same_forest(a, b)
    for k in TRIO_FIELDS:
        a, b = getattr(port, k), getattr(jax, k)
        assert (a is None) == (b is None), k
        for x, y in zip(a or (), b or ()):
            assert_same_forest(x, y)
    for k in ("stage2_class_order", "play_temperature", "play_classes"):
        assert getattr(port, k) == getattr(jax, k), k
