"""K1 (`ops/game.nano_game`) under exact and analytic heads, on the CPU.

The kernel runs only on the card (`chip_smoke.py` phase 21 holds its exact
and analytic instantiations to the eager loop and to `nano_game_plain`
there).  Here the plain version, on the arguments `pack_nano_game` packs for
a HeadsPack (exact mode's forests) or for no heads state (the analytic
heads), is held bit for bit to the eager game loop (`simulate_games_eager`)
on every GameState field, the collectors' box score and player stats
included; to the JAX package's exact `play_step` scanned over one draw table
at the whole-game standard of tests/test_torch_game.py; the links K1 and
the eager heads share (`forest_eval.sigmoid_f32`, `softmax_f32`,
`game.play_link`) to the JAX package's; the forests as K1 walks them (the
concatenated records, tiles and descriptors of `exact_forests`) to their
plain walk, decoded as the kernel decodes them; the packer's refusals; and
the predicate that picks K1.  Heads: `fixtures.heads(seed, "small")` on the
focus-roster fixture teams, whose players the heads' splits name."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
from fast_monte_carlo_tpu.ops import game as jg
from fast_monte_carlo_tpu.ops.pack import build_packs as jax_build_packs
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.matchup import build_direction
from fast_monte_carlo_tpu_torch.models import forest as tforest
from fast_monte_carlo_tpu_torch.models.heads import ST1_FEATURES
from fast_monte_carlo_tpu_torch.ops import forest_eval as tfe
from fast_monte_carlo_tpu_torch.ops import game as tg
from fast_monte_carlo_tpu_torch.ops import pack as tpack
from fast_monte_carlo_tpu_torch.ops.rng import fold_in, root_key

from test_torch_support import (FOCUS_SEED, jax_heads, jax_teams, port_pack,
                                write_focus)
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

HEADS_SEED = 11
N = 192
FIELDS = tg.GameState._fields


def _cfg(full: bool = False, **engine) -> SimConfig:
    """The default config (stage 1, stage 2, nine quantile forests), or with
    the fumble head and the ML play policy on; engine fields replaced."""
    cfg = SimConfig()
    if full:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, enable_fumbles=True,
                                                    use_play_model=True))
    return cfg.replace(engine=dataclasses.replace(cfg.engine, **engine)) if engine else cfg


@pytest.fixture(scope="module")
def heads():
    return fixtures.heads(HEADS_SEED, "small")


def _packs(heads, cfg):
    return tpack.build_packs(*fixtures.focus_teams(FOCUS_SEED), heads, cfg, "cpu",
                             fixtures.COACH_MAP)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A field as its bits: f32 seen as int32, so -0.0 and +0.0 differ."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _start(cfg, n: int, k: int, start: str, players: bool, stats: bool):
    fo = torch.arange(n, dtype=torch.int32) % 2
    coll = dict(collect_players=players, collect_stats=stats)
    if start == "kickoff":
        return tg.initial_state(n, fo, cfg, "cpu", k=k, **coll)
    if start == "fourth":     # 4th and 2 at midfield, the 4th-down evaluator's start
        sit = tg.Situation(fo, 1500, 4, 2.0, 45.0, 10, 14)
    else:                     # late-game situations, varied clocks and scores
        sit = tg.Situation(fo, 400 + torch.arange(n, dtype=torch.int32) * 3, 2, 7.0, 42.0, 17,
                           14 + torch.arange(n, dtype=torch.int32) % 9)
    return tg.state_from_situation(n, sit, cfg, "cpu", k=k, **coll)


def _plain_equals_eager(pack, cfg, he, hs, start="kickoff", players=False, stats=False,
                        force=None, row0=0, n=N):
    """`nano_game` on the CPU (its plain version on `pack_nano_game`'s
    arguments) against `simulate_games_eager` on the same start state: every
    field bit for bit, stats and pstats in place."""
    key = root_key(31)
    s0 = _start(cfg, n, pack.k, start, players, stats)
    a, b = (tg.GameState(*(f.clone() for f in s0)) for _ in range(2))
    coll = dict(collect_players=players, collect_stats=stats)
    fk = fold_in(key, 1 << 20) if force else None
    want = tg.simulate_games_eager(pack, cfg, he, hs, key, n, 0, init_state=a, row0=row0,
                                   first_play_force=force, first_play_key=fk, **coll)
    anti = cfg.engine.antithetic and n % 4 == 0
    args = tg.pack_nano_game(pack, cfg, hs)
    got = tg.nano_game(args, b, key, row0, anti, force=force, force_key=fk, **coll)
    assert got.stats is b.stats and got.pstats is b.pstats
    for f in FIELDS:
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f
    assert (got.sec == 0).all() and tg.nano_game_cuda.launches == 0
    if start == "kickoff":
        assert 10 < float(got.score.float().mean()) < 40
    return args, got


# case: (config, start, collect_players, collect_stats, forced first play, row0)
EXACT_CASES = {
    "score_only": (_cfg(), "kickoff", False, False, None, 0),
    "fumble_and_play_heads": (_cfg(full=True), "kickoff", False, False, None, 0),
    "both_collectors": (_cfg(full=True), "kickoff", True, True, None, 0),
    "box_score": (_cfg(), "kickoff", False, True, None, 0),
    "player_stats": (_cfg(), "kickoff", True, False, None, 0),
    "forced_go": (_cfg(), "fourth", False, False, "go", 0),
    "forced_punt_both_collectors": (_cfg(), "fourth", True, True, "punt", 0),
    "antithetic_row0": (_cfg(full=True, antithetic=True), "situation", False, False, None, 8),
}


@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_nano_game_plain_equals_eager_loop_exact(case, heads):
    """Exact mode: K1's plain version on the packed forests (each walked on
    K5's records by `eval_margin_packed`, its link `forest_link`) plays the
    games of the eager loop (`make_exact_heads_eval`, `eval_margin`'s plain
    walk on the CPU) bit for bit, score-only and with each collector, from a
    kickoff, a forced first play and resumed situations."""
    cfg, start, players, stats, force, row0 = EXACT_CASES[case]
    pack, hp = _packs(heads, cfg)
    args, _ = _plain_equals_eager(pack, cfg, tg.make_exact_heads_eval(cfg), hp, start,
                                  players, stats, force, row0)
    assert tg.LAYOUT_KINDS[args.kind] == "exact" and args.table_layout == "exact"
    read = [h for h, *_ in args.exact.heads]
    assert ("fumble" in read, "play" in read) == (cfg.model.enable_fumbles,
                                                  cfg.model.use_play_model)


def test_nano_game_plain_equals_eager_loop_exact_slate(heads):
    """Exact mode over a 3-matchup pack with rosters (`fixtures.focus_slate`,
    game g of matchup g % 3, both collectors): each game reads its
    matchup's directions and id tables."""
    cfg = _cfg(full=True)
    ms, _ = fixtures.focus_slate(3, 11)
    dirs = []
    for a, b in ms:
        dirs += [build_direction(a, b, cfg, heads, fixtures.COACH_MAP),
                 build_direction(b, a, cfg, heads, fixtures.COACH_MAP)]
    pack = tpack.pack_matchups(dirs, "cpu")
    hp = tpack.pack_heads(heads, "cpu")
    n, key = N, root_key(33)
    fo = torch.arange(n, dtype=torch.int32) % 2
    gid = torch.arange(n, dtype=torch.int32) % 3
    s0 = tg.initial_state(n, fo, cfg, "cpu", gid, pack.k)
    a, b = (tg.GameState(*(f.clone() for f in s0)) for _ in range(2))
    want = tg.simulate_games_eager(pack, cfg, tg.make_exact_heads_eval(cfg), hp, key, n, 0,
                                   init_state=a)
    args = tg.pack_nano_game(pack, cfg, hp)
    got = tg.nano_game(args, b, key, collect_players=True, collect_stats=True)
    assert args.ids.shape == (len(tg.EXACT_ID_TABLES), 6, pack.k)
    for f in FIELDS:
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f
    assert float(got.pstats.abs().sum()) > 0


def test_nano_game_plain_equals_eager_loop_exact_without_stage2(heads):
    """Exact heads with no stage-2 forest take the analytic stage 2 in K1
    as in the eager step; fourth.force on every play."""
    cfg = _cfg().replace(fourth=dataclasses.replace(SimConfig().fourth, force="fg"))
    pack, hp = _packs(heads, cfg)
    hp = dataclasses.replace(hp, stage2=None)
    args, _ = _plain_equals_eager(pack, cfg, tg.make_exact_heads_eval(cfg), hp)
    assert args.consts.has_s2 == 0 and args.layout.v_stage2 == -1


# case: (config, start, collect_players, collect_stats, forced first play, row0)
ANALYTIC_CASES = {
    "score_only": (_cfg(), "kickoff", False, False, None, 0),
    "both_collectors": (_cfg(), "kickoff", True, True, None, 0),
    "forced_go": (_cfg(), "fourth", False, False, "go", 0),
    "fourth_force_punt": (SimConfig().replace(fourth=dataclasses.replace(
        SimConfig().fourth, force="punt")), "kickoff", False, False, None, 0),
    "antithetic_row0": (_cfg(antithetic=True), "situation", True, False, None, 4 * N),
}


@pytest.mark.parametrize("case", list(ANALYTIC_CASES))
def test_nano_game_plain_equals_eager_loop_analytic(case):
    """The analytic heads: K1's plain version (the closed forms of
    `analytic_channels` on each direction's bias in `xdirs`) plays the eager
    loop's games bit for bit."""
    cfg, start, players, stats, force, row0 = ANALYTIC_CASES[case]
    pack, _ = _packs(fixtures.heads(HEADS_SEED, "small"), cfg)
    args, _ = _plain_equals_eager(pack, cfg, tg.make_analytic_heads_eval(cfg), None, start,
                                  players, stats, force, row0, n=4 * N)
    assert tg.LAYOUT_KINDS[args.kind] == "analytic" and args.exact is None


def test_nano_game_plain_exact_matches_jax_on_one_draw_table(heads, tmp_path):
    """256 games fed one (max_plays, B, 17) draw table: `nano_game_plain` on
    the packed forests of the full heads (fumble and play heads on) against
    the JAX package's exact `play_step` scanned over the same table, the
    whole-game standard of tests/test_torch_game.py: at least 98% of final
    scores equal (a head a few ulps apart can cross a threshold: the
    forests' class sums and the links run in other orders there)."""
    b = 256
    cfg = _cfg(full=True)
    jcfg = JaxSimConfig()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, enable_fumbles=True,
                                                  use_play_model=True))
    rng = np.random.default_rng(14)
    u, z = fixtures.play_draws(rng, (cfg.engine.max_plays, b))
    jpack, jhp = jax_build_packs(*jax_teams(8, write_focus(tmp_path / "focus.csv")),
                                 jax_heads(heads), jcfg, fixtures.COACH_MAP)
    pack = port_pack(jpack)
    hp = tpack.pack_heads(heads, "cpu")
    fo = np.arange(b) % 2
    jhe = jg.make_exact_heads_eval(jcfg)

    def run_jax(h, uu, zz):
        s0 = jg.initial_state(b, jnp.asarray(fo, jnp.int32), jcfg, 8,
                              collect_players=False, collect_stats=False)

        def body(s, xs):
            return jg.play_step(s, jax.random.PRNGKey(0), jpack, jcfg, jhe, h, False, False,
                                draws=xs), None

        return jax.lax.scan(body, s0, (uu, zz))[0]

    want = np.asarray(jax.jit(run_jax)(jhp, jnp.asarray(u), jnp.asarray(z)).score)
    s0 = tg.initial_state(b, torch.from_numpy(fo), cfg, "cpu", k=pack.k,
                          collect_players=False, collect_stats=False)
    got = tg.nano_game_plain(tg.pack_nano_game(pack, cfg, hp), s0, 0,
                             draws=(torch.from_numpy(u), torch.from_numpy(z)))
    assert (got.sec == 0).all()
    same = (got.score.numpy() == want).all(axis=1)
    assert same.mean() >= 0.98, f"{(~same).sum()} of {b} games differ"
    assert 10 < want.mean() < 50


def test_links_match_jax():
    """The links as explicit f32 operations (the order K1 computes them in)
    against the JAX package's `jax.nn.sigmoid`, `jax.nn.softmax` and its
    play head's reduction, on the same margins: within 5e-7 relative (a few
    ulps: the two packages' exp differ by an ulp here and there), P(pass)
    of the play head within 2e-7 absolute too (its two divisions carry an
    ulp of each exp)."""
    rng = np.random.default_rng(3)
    m = (rng.standard_normal((4096, 5)) * 3).astype(np.float32)
    mt = torch.from_numpy(m)
    np.testing.assert_allclose(tfe.sigmoid_f32(mt[:, 0]).numpy(),
                               np.asarray(jax.nn.sigmoid(jnp.asarray(m[:, 0]))), rtol=5e-7)
    for c in (2, 3, 5):
        np.testing.assert_allclose(tfe.softmax_f32(mt[:, :c]).numpy(),
                                   np.asarray(jax.nn.softmax(jnp.asarray(m[:, :c]), axis=1)),
                                   rtol=5e-7, atol=1e-9)
    temp, lo, hi = 1.25, 0.02, 0.98
    p = jax.nn.softmax(jnp.asarray(m) / temp, axis=1)
    want = jnp.clip(p[:, 1] / jnp.maximum(1e-9, p[:, 1] + p[:, 3]), lo, hi)
    got = tg.play_link(mt, tg.analytic.recip(temp), 1, 3, lo, hi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-7, atol=2e-7)


def _decoded_margins(ex: tg.ExactForests, fi: int, rows: torch.Tensor) -> torch.Tensor:
    """Forest fi's margins (B, C) of staged rows (B, 4 + 17) int32, read from
    the concatenated tensors K1 reads, as the kernel decodes them: its
    descriptor, its tiles (first record, first and end tree), each tree's
    root at its tile's first record plus its offset, `steps` levels of the
    record walk, the leaves added by class in tree order, the base."""
    desc = ex.forests[fi].tolist()
    first_tile, n_tiles, classes, _, lt, zam, steps = desc[:7]
    base = torch.tensor(desc[12:12 + classes], dtype=torch.int32).view(torch.float32)
    acc = torch.zeros((rows.shape[0], classes))
    for tile in ex.tiles[first_tile:first_tile + n_tiles].tolist():
        rec0, _, t0, t1, forest, *_ = tile
        assert forest == fi
        for t in range(t0, t1):
            root = rec0 + int(ex.tree_off[t])
            node = torch.zeros(rows.shape[0], dtype=torch.int64)
            for _ in range(steps):
                rec = ex.records[root + node]
                meta = rec[:, 1]
                w = torch.gather(rows, 1, ((meta & tfe.SLOT_MASK) >> 2)[:, None].long())[:, 0]
                wf, th = w.view(torch.float32), rec[:, 0].view(torch.float32)
                right = ~(wf < th) if lt else ~(wf <= th)
                if zam:
                    right = torch.where(wf == 0.0, (meta & tfe.DEFAULT_RIGHT_BIT) != 0, right)
                cat = torch.where(w == rec[:, 0], (meta & tfe.CAT_MATCH_RIGHT_BIT) != 0,
                                  (meta & tfe.CAT_MISS_RIGHT_BIT) != 0)
                right = torch.where((meta & tfe.IS_CAT_BIT) != 0, cat, right)
                node = (((meta >> tfe.LEFT_SHIFT) & 0x7FFF) >> 3).long() + right.long()
            c = int(ex.tree_class[t])
            acc[:, c] = acc[:, c] + ex.records[root + node, 0].view(torch.float32)
    return acc + base


# heads: (fixture shape, the most tiles a forest spans there)
DECODE_HEADS = {"small": 1, "reference": 2, "tiled": 8}


@pytest.mark.parametrize("shape", list(DECODE_HEADS))
def test_exact_forests_walk_as_their_plain_walk(shape, heads):
    """The forests as K1 walks them (every forest's records in one tensor,
    the play head's numerics re-pointed at their ST1 columns, the tiles,
    tree offsets and classes concatenated, the descriptors), decoded as the
    kernel decodes them on one staged row of 21 words a play: each forest's
    margins bitwise those of its plain walk on its own records
    (`eval_margin_packed`), with each group's id in the first words.  On
    the small heads, the reference-shape ones (a 400-tree forest over two
    tiles) and the tiled ones (stage 1 and the 5-class play head over
    eight tiles each, so a forest's class sums carry over middle tiles)."""
    cfg = _cfg(full=True)
    h = heads if shape == "small" else fixtures.heads(HEADS_SEED, shape)
    pack, hp = _packs(h, cfg)
    ex = tg.pack_nano_game(pack, cfg, hp).exact
    assert ex is tg.exact_forests(hp, True, True)          # memoized on the HeadsPack
    assert [h for h, *_ in ex.heads] == ["play", "stage1", "stage2"] + ["rq"] * 3 + \
        ["fumble"] + ["pq"] * 3 + ["sq"] * 3
    rng = np.random.default_rng(5)
    n = 512
    d = fixtures.play_states(rng, n)
    x = torch.from_numpy(rng.standard_normal((n, 17)).astype(np.float32) * 20)
    x[:, 0] = torch.from_numpy(d["down"].astype(np.float32))
    for fi, (head, tf, cols, groups) in enumerate(ex.heads):
        ids = torch.full((n, tfe.MAX_GROUPS), -1, dtype=torch.int32)
        cat = {}
        for g, (name, src) in enumerate(zip(tf.group_names, groups)):
            if src is not None:
                v = torch.from_numpy(rng.integers(-1, 12, n).astype(np.int32))
                ids[:, g], cat[name] = v, v
        rows = torch.cat([ids, x.view(torch.int32)], dim=1)
        want = tfe.eval_margin_packed(tf, x[:, list(cols)].contiguous(), cat)
        assert torch.equal(_decoded_margins(ex, fi, rows), want), head
    t = ex.tiles
    assert int(ex.forests[:, 1].max()) == DECODE_HEADS[shape]
    assert (ex.records.shape[0] % 2 == 0) and bool((t[:, 0] % 2 == 0).all())
    assert bool((t[:, 1] % 16 == 0).all()) and int(t[:, 1].max()) <= tfe.TILE_RECORDS * 8
    assert int(t[-1, 3]) == ex.tree_off.shape[0] == ex.tree_class.shape[0]


def _one_tree_forest(groups=(), numerics=ST1_FEATURES, depth=2, classes=1):
    """A forest of one complete tree of `depth` levels (every split on the
    first numeric at 0.5) and `classes` classes."""
    lay = tforest.FeatureLayout(tuple(groups), tuple(2 for _ in groups), tuple(numerics),
                                {g: ("a", "b") for g in groups})
    n = 2 ** depth - 1
    internal = np.arange(n) < 2 ** (depth - 1) - 1
    idx = np.arange(n)
    tree = {"feat": np.where(internal, lay.n_cat, -1), "thresh": np.where(internal, 0.5, 0.0),
            "left": np.where(internal, 2 * idx + 1, -1),
            "right": np.where(internal, 2 * idx + 2, -1),
            "default_left": np.zeros(n, bool), "leaf": np.where(internal, 0.0, 0.25)}
    return tforest.stack_nodes([tree], lay, tree_class=[0], n_classes=classes,
                               base_margin=np.zeros(classes, np.float32),
                               link="identity" if classes == 1 else "softmax", cmp="le",
                               name="wide")


@pytest.mark.parametrize("head,forest,match", [
    ("stage1", lambda: _one_tree_forest(groups=[f"g{i}" for i in range(5)]), "category groups"),
    ("stage1", lambda: _one_tree_forest(numerics=[f"n{i}" for i in range(65)]),
     "numeric features"),
    ("sq", lambda: _one_tree_forest(depth=13), "a tree of 8191 records"),
    ("stage2", lambda: _one_tree_forest(classes=9), "9 classes"),
    ("stage1", lambda: _one_tree_forest(numerics=[f"n{i}" for i in range(18)]), "18 numerics"),
])
def test_exact_packer_refuses_what_the_kernel_cannot_take(head, forest, match, heads):
    """Past K5's limits (4 groups, 64 numerics, 4,096 records a tree, 8
    classes) and past a play's ST1 row, `pack_nano_game` raises ValueError
    for exact heads, before any launch."""
    cfg = _cfg()
    pack, hp = _packs(heads, cfg)
    tf = tfe.pack_forest(forest(), "cpu")
    hp = dataclasses.replace(hp, **{head: (tf, tf, tf) if head == "sq" else tf})
    with pytest.raises(ValueError, match=match):
        tg.pack_nano_game(pack, cfg, hp)


# case: (heads eval, heads state, config change, K1 covers it)
COVER_CASES = {
    "analytic": ("analytic", None, None, True),
    "analytic_forced_go": ("analytic", None, "go", True),
    "analytic_with_a_heads_pack": ("analytic", "heads", None, False),
    "exact": ("exact", "heads", None, True),
    "exact_fumble_and_play": ("exact", "heads", "full", True),
    "exact_forced_punt": ("exact", "heads", "punt", True),
    "exact_without_a_heads_pack": ("exact", None, None, False),
    "exact_without_rush_quantiles": ("exact", "no_rq", None, False),
    "unknown_force": ("exact", "heads", "bad", False),
}


@pytest.mark.parametrize("case", list(COVER_CASES))
def test_nano_game_covers_exact_and_analytic(case, heads):
    """K1 takes exact heads on a HeadsPack with stage 1 and the three
    quantile trios, and the analytic heads with no heads state, under any
    fourth.force; a launch it takes packs to its exact or analytic
    instantiation."""
    kind, state, change, covered = COVER_CASES[case]
    cfg = _cfg(full=change == "full")
    if change in ("go", "punt", "bad"):
        cfg = cfg.replace(fourth=dataclasses.replace(cfg.fourth, force=change))
    pack, hp = _packs(heads, cfg)
    hs = {"heads": hp, "no_rq": dataclasses.replace(hp, rq=None), None: None}[state]
    he = {"exact": tg.make_exact_heads_eval, "analytic": tg.make_analytic_heads_eval}[kind](cfg)
    assert tg.nano_game_covers(cfg, he, hs) is covered
    if covered:
        args = tg.pack_nano_game(pack, cfg, hs)
        assert tg.nano_kind(args, "go" if change == "go" else None) == \
            tg.LAYOUT_KINDS.index(kind)


def test_smoke_bounds_of_the_heads_without_tables(heads):
    """chip_smoke's bound of K1's exact and analytic launches
    (`layout_bound`): NANO_COUNTS less the nano profile's binning and the
    row's loads a play; in exact mode the three slots sampled, the given
    walks a row a play, and the forests' records read once; the games'
    state read and written once."""
    import chip_smoke as cs

    cfg = _cfg()
    pack, hp = _packs(heads, cfg)
    games, plays = 4096, 700_000
    state = games * (cs.NANO_STATE_IN + cs.NANO_STATE_OUT)
    base = dict(cs.NANO_COUNTS)
    cs._add(base, cs.bin_counts([5, 8, 8, 1]), -1)
    base["dispatch"] -= cs.NANO_ROW_LOADS
    got = cs.layout_bound(tg.pack_nano_game(pack, cfg, None), games, plays)
    assert got == cs.bound(state, cs.per(base, plays))
    walk = {"alu": 900.0, "dispatch": 3000.0}
    args = tg.pack_nano_game(pack, cfg, hp)
    cs._add(base, cs.HEAD_SLOT_COUNTS, 3)
    for k, v in walk.items():
        base[k] += v
    got = cs.layout_bound(args, games, plays, walk=walk)
    assert got == cs.bound(state + args.exact.records.numel() * 4, cs.per(base, plays))
    assert got["bound_by"] == "operations"
    assert {"nano_game_exact", "nano_game_analytic"} <= set(cs.KERNEL_SOURCES) & set(cs.REPLACES)
    assert {"nano_game_exact", "nano_game_analytic"} <= set(cs.K1_ROWS)


def test_sass_compare_ignores_the_anonymous_namespace_hash(tmp_path):
    """`probes.kernels.compare_sass_dir`: a kernel of another commit's dump
    is held to the kernel of the same name here, the anonymous namespace's
    hash (which follows the file's bytes) left out of the name; a kernel
    that exists on one side only is not compared."""
    from fast_monte_carlo_tpu_torch.probes import kernels

    def dump(path, funcs):
        path.parent.mkdir(parents=True, exist_ok=True)
        lines = []
        for name, ins in funcs.items():
            lines.append(f"\t\tFunction : {name}")
            lines += [f"        /*{16 * i:04x}*/                   {x} ;" for i, x in
                      enumerate(ins)]
        path.write_text("\n".join(lines) + "\n")

    k5 = "_ZN45_GLOBAL__N__{}_14_forest_eval_cu_08f1be2118forest_eval_kernelILi2ELb0ELb0EEEv"
    k1 = "_ZN45_GLOBAL__N__{}_12_nano_game_cu_26cab68616nano_game_kernelILi7ELb0ELb0EEEv"
    dump(tmp_path / "old" / "forest_eval.sass", {k5.format("606f7004"): ["MOV R1, c[0x0][0x28]",
                                                                          "EXIT"]})
    dump(tmp_path / "new" / "forest_eval.sass", {k5.format("f548ac2a"): ["MOV R1, c[0x0][0x28]",
                                                                          "EXIT"]})
    dump(tmp_path / "old" / "nano_game.sass", {})
    dump(tmp_path / "new" / "nano_game.sass", {k1.format("f548ac2a"): ["EXIT"]})
    got = kernels.compare_sass_dir(tmp_path / "new", tmp_path / "old")
    assert list(got) == ["forest_eval " + k5.format("").replace("__N___", "__N__")]
    assert got[list(got)[0]] == {"instructions": 2, "old_instructions": 2, "differing_lines": 0,
                                 "identical": True}
