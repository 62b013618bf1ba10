"""K1, the game kernel (`ops/game.nano_game`), and K2, the moment kernel
(`parallel/aggregate.exact_moments_cuda`), on the CPU.

The kernels run only on the card (`chip_smoke.py` phase 21 holds them to
their plain versions there).  Here K1's plain version, `nano_game_plain`,
which reads exactly the packed inputs the launcher passes, is held bit for
bit to the eager game loop (`simulate_games_eager`) on every GameState
field, the collectors' box score and player stats included, and within the
98%-of-games standard of tests/test_torch_game.py to the JAX package's
`play_step` scanned over one draw table; the predicate
that picks K1 is checked over a table of cases; the packed constants and
the launchers' parameters are checked against the kernels' sources.  K1's
work queue hands games to lanes in any order, so a game's result must
depend on its start state and its draw row alone: pieces of a launch
played alone at their own row offsets, in a shuffled order, give the
launch's games; the grid and cluster geometry are checked on shapes the
CPU can count."""
import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
from fast_monte_carlo_tpu.ops import game as jg
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.api import MatchupRunner
from fast_monte_carlo_tpu_torch.config import SimConfig, classic_config
from fast_monte_carlo_tpu_torch.matchup import build_direction
from fast_monte_carlo_tpu_torch.models.tables import (TableProfile, edges_from_reps,
                                                      marginalize_sd, nano_from_fused,
                                                      nano_profile, sd_reps_default)
from fast_monte_carlo_tpu_torch.ops import game as tg
from fast_monte_carlo_tpu_torch.ops import table_lookup as ttl
from fast_monte_carlo_tpu_torch.ops.pack import pack_matchups
from fast_monte_carlo_tpu_torch.ops.rng import fold_in, root_key, step_draws
from fast_monte_carlo_tpu_torch.parallel import aggregate as tagg
from fast_monte_carlo_tpu_torch.stats import PC_ATT, PC_YDS, TEAM_STAT_FIELDS, TS
from fast_monte_carlo_tpu_torch.utils.cuda_build import CSRC

from test_torch_support import (FOCUS_SEED, TABLE_SEED, heads_pair, jax_pack, port_pack,
                                table_cache_off, write_focus)  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

N = 256
FIELDS = ("gid", "fo", "off", "sec", "down", "dist", "ytg", "period", "in_rz", "going",
          "score", "stats", "pstats")


def _cfg(base=None, **engine):
    cfg = base or SimConfig()
    return cfg.replace(engine=dataclasses.replace(cfg.engine, **engine))


def _pack_and_tables(g: int = 1, s2_fumble: bool = False, sd_mode: str = "axis"):
    """A pack of g matchups and their nano tables: the fixture teams (g = 1)
    or `fixtures.slate(g, ...)`; with `sd_mode` "frozen" the tables' score
    diff axis collapsed (nsd = 1)."""
    cfg = SimConfig()
    if g == 1:
        ms, tables = [fixtures.teams()], [fixtures.nano_tables(TABLE_SEED, s2_fumble)]
    else:
        ms, tables = fixtures.slate(g, 11)
    if sd_mode != "axis":
        prof = nano_profile()
        tables = [tuple(nano_from_fused(marginalize_sd(t, prof, sd_mode), prof)
                        for t in fixtures.fused_tables(TABLE_SEED))]
    dirs = []
    for a, b in ms:
        dirs += [build_direction(a, b, cfg), build_direction(b, a, cfg)]
    return pack_matchups(dirs, "cpu"), ttl.pack_tables_multi(tables, "cpu")


def _forced_start(pack, th, cfg, n):
    """What `_forced_moments` hands the game loop: one play forced to 'go'
    from a 4th-and-2 situation on draws of its own."""
    sit = tg.Situation(0, 1500, 4, 2.0, 45.0, 10, 14)
    s = tg.state_from_situation(n, sit, cfg, "cpu", collect_players=False,
                                collect_stats=False)
    cfg_f = cfg.replace(fourth=dataclasses.replace(cfg.fourth, force="go"))
    draws = step_draws(fold_in(root_key(9), 1), 0, n, "cpu")
    return tg.play_step(s, draws, pack, cfg_f, ttl.make_table_heads_eval(cfg), th)


# case: (matchups, s2 and fumble channels, sd mode, config, start, row0)
CASES = {
    "kickoff": (1, False, "axis", SimConfig(), "kickoff", 0),
    "antithetic": (1, False, "axis", _cfg(antithetic=True), "kickoff", 0),
    "situation": (1, False, "axis", SimConfig(), "situation", 0),
    "init_state": (1, False, "axis", SimConfig(), "init_state", 0),
    "row0": (1, False, "axis", SimConfig(), "kickoff", 4 * N),
    "antithetic_row0": (1, False, "axis", _cfg(antithetic=True), "kickoff", 2 * N),
    "slate": (3, False, "axis", SimConfig(), "kickoff", 0),
    "s2_fumble": (1, True, "axis", SimConfig().replace(model=dataclasses.replace(
        SimConfig().model, enable_fumbles=True)), "kickoff", 0),
    "sd_frozen": (1, False, "frozen", SimConfig(), "kickoff", 0),
    "classic": (1, False, "axis", classic_config(), "kickoff", 0),
    "no_early_exit": (1, False, "axis", _cfg(early_exit=False, max_plays=120), "situation", 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_nano_game_plain_equals_eager_loop(case):
    """`nano_game` on the CPU (its plain version, on `pack_nano_game`'s
    packed inputs) plays the games `simulate_games_eager` plays, bit for
    bit on every GameState field, from each start, with each table layout
    K1 takes, and over a 3-matchup slate in the game layout."""
    g, s2_fumble, sd_mode, cfg, start, row0 = CASES[case]
    pack, th = _pack_and_tables(g, s2_fumble, sd_mode)
    assert th.fused_has_s2 == th.fused_has_fumble == s2_fumble
    assert th.nano_nsd == (1 if sd_mode != "axis" else 3)
    he = ttl.make_table_heads_eval(cfg)
    n = N if g == 1 else 64 * g
    fo = torch.arange(n, dtype=torch.int32) % 2
    gid = torch.arange(n, dtype=torch.int32) // (n // g)
    kw = dict(collect_players=False, collect_stats=False, row0=row0)
    key = root_key(21)
    if start == "kickoff":
        want = tg.simulate_games_eager(pack, cfg, he, th, key, n, fo, game_id=gid, **kw)
        s0 = tg.initial_state(n, fo, cfg, "cpu", gid, collect_players=False,
                              collect_stats=False)
    elif start == "situation":
        # one late-game situation a game: Q4, varied clocks and scores
        sit = tg.Situation(fo, 400 + torch.arange(n, dtype=torch.int32) * 3, 2, 7.0, 42.0,
                           17, 14 + torch.arange(n, dtype=torch.int32) % 9)
        want = tg.simulate_games_eager(pack, cfg, he, th, key, n, 0, situation=sit, **kw)
        s0 = tg.state_from_situation(n, sit, cfg, "cpu", collect_players=False,
                                     collect_stats=False)
    else:
        s0 = _forced_start(pack, th, cfg, n)
        want = tg.simulate_games_eager(pack, cfg, he, th, key, n, 0, init_state=s0, **kw)
    anti = cfg.engine.antithetic and n % 4 == 0
    got = tg.nano_game(tg.pack_nano_game(pack, cfg, th), s0, key, row0, anti)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert not bool(got.going.any())
    if start == "kickoff":
        assert (got.sec == 0).all() and 10 < float(got.score.float().mean()) < 40
    assert tg.nano_game_cuda.launches == 0


def _focus_pack(kind: str, tmp_path):
    """(pack, nano tables, matchups) with rosters: the fixture teams with
    `fixtures.focus_teams`' rosters at 8 player slots ("focus") or 1
    ("focus_k1"), the JAX package's pack of the same focus sheet
    ("jax_focus"), or `fixtures.focus_slate(3, ...)` ("focus_slate")."""
    cfg = SimConfig()
    if kind == "jax_focus":
        jpack = jax_pack(focus_csv=write_focus(tmp_path / "focus.csv"))
        return port_pack(jpack), ttl.pack_tables_multi([fixtures.nano_tables(TABLE_SEED)],
                                                       "cpu"), 1
    if kind == "focus_slate":
        ms, tables = fixtures.focus_slate(3, 11)
    else:
        ms = [fixtures.focus_teams(FOCUS_SEED, player_slots=1 if kind == "focus_k1" else 8)]
        tables = [fixtures.nano_tables(TABLE_SEED)]
    dirs = []
    for a, b in ms:
        dirs += [build_direction(a, b, cfg), build_direction(b, a, cfg)]
    return pack_matchups(dirs, "cpu"), ttl.pack_tables_multi(tables, "cpu"), len(ms)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A field as its bits: f32 seen as int32, so -0.0 and +0.0 differ."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


RESUMED_PLAYS = 40     # eager plays with the collectors on before the resumed launch
# case: (pack, config, start, collect_players, collect_stats)
COLLECT_CASES = {
    "stats": ("focus", SimConfig(), "kickoff", False, True),
    "players": ("focus", SimConfig(), "kickoff", True, False),
    "both": ("focus", SimConfig(), "kickoff", True, True),
    "both_antithetic": ("focus", _cfg(antithetic=True), "kickoff", True, True),
    "both_jax_focus_pack": ("jax_focus", SimConfig(), "kickoff", True, True),
    "both_slate": ("focus_slate", SimConfig(), "kickoff", True, True),
    "both_one_slot": ("focus_k1", SimConfig(), "kickoff", True, True),
    "both_nonzero_init_state": ("focus", SimConfig(), "resumed", True, True),
}


@pytest.mark.parametrize("case", list(COLLECT_CASES))
def test_nano_game_plain_accrues_as_the_eager_loop(case, tmp_path):
    """With the collectors on, `nano_game` on the CPU plays and accrues what
    `simulate_games_eager` does, bit for bit on every field (f32 compared
    as bits), `stats` and `pstats` included, in place on the start state's
    tensors: the box score, the player rows of the sampled slots, `points`
    set to the final score.  K1 and its plain version add nothing for a
    game that has ended, nor a row for an untracked slot or a role the
    play does not involve, where the eager step adds +0.0: these runs show
    the adds it leaves out change no bit, from a kickoff and from a state
    whose stats and pstats are already nonzero."""
    kind, cfg, start, players, stats = COLLECT_CASES[case]
    pack, th, g = _focus_pack(kind, tmp_path)
    he = ttl.make_table_heads_eval(cfg)
    n = N if g == 1 else 64 * g
    fo = torch.arange(n, dtype=torch.int32) % 2
    gid = torch.arange(n, dtype=torch.int32) // (n // g)
    coll = dict(collect_players=players, collect_stats=stats)
    key = root_key(23)
    s0 = tg.initial_state(n, fo, cfg, "cpu", gid, pack.k, **coll)
    if start == "resumed":
        for j in range(RESUMED_PLAYS):
            s0 = tg.play_step(s0, step_draws(fold_in(key, 7), j, n, "cpu"), pack, cfg, he, th,
                              players, stats)
        assert float(s0.stats.abs().sum()) > 0 and float(s0.pstats.abs().sum()) > 0
        assert bool((s0.sec > 0).all())
    a, b = (tg.GameState(*(f.clone() for f in s0)) for _ in range(2))
    want = tg.simulate_games_eager(pack, cfg, he, th, key, n, 0, init_state=a, **coll)
    anti = cfg.engine.antithetic and n % 4 == 0
    got = tg.nano_game(tg.pack_nano_game(pack, cfg, th), b, key, 0, anti, **coll)
    assert got.stats is b.stats and got.pstats is b.pstats and want.stats is a.stats
    for f in FIELDS:
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f
    assert (got.sec == 0).all() and tg.nano_game_cuda.launches == 0
    if stats:
        assert torch.equal(got.stats[:, :, TS["points"]], got.score.float())
        assert got.stats.shape == (n, 2, len(TEAM_STAT_FIELDS))
        assert float(got.stats[..., TS["pass_yds"]].sum()) > 0
    if players:
        assert got.pstats.shape == (n, 2, 3, pack.k, 6)
        assert float(got.pstats[..., PC_ATT].sum()) > 0
    if start == "resumed":
        grew = got.stats[..., TS["plays"]] > s0.stats[..., TS["plays"]]
        assert bool(grew.any(dim=1).all())


def test_nano_game_plain_matches_jax_on_one_draw_table(tmp_path):
    """512 games fed one (max_plays, B, 17) draw table: `nano_game_plain`
    on the fixture nano table and the focus roster, both collectors on,
    against the JAX package's `play_step` scanned over the same table with
    both collectors on, the whole-game standard of tests/test_torch_game.py
    (>= 98% of final scores equal; the rest sit within an ulp of a
    threshold, where XLA's FMAs round otherwise).  On the games whose final
    scores are equal, every count column of the box score and the player
    stats is equal and the yards agree within rtol 1e-5, atol 1e-3 (XLA's
    FMAs again); `points` is the final score, as the JAX package's
    `simulate_games` writes it after the scan."""
    b = 512
    cfg, jcfg = SimConfig(), JaxSimConfig()
    steps = cfg.engine.max_plays
    rng = np.random.default_rng(12)
    u, z = fixtures.play_draws(rng, (steps, b))
    jpack = jax_pack(focus_csv=write_focus(tmp_path / "focus.csv"))
    pack = port_pack(jpack)
    assert bool(pack.qb_tracked.any()) and pack.k == 8
    jhe, jhs, _, th = heads_pair("table")
    fo = np.arange(b) % 2

    def run_jax(h, uu, zz):
        s0 = jg.initial_state(b, jnp.asarray(fo, jnp.int32), jcfg, 8,
                              collect_players=True, collect_stats=True)

        def body(s, xs):
            return jg.play_step(s, jax.random.PRNGKey(0), jpack, jcfg, jhe, h,
                                True, True, draws=xs), None

        return jax.lax.scan(body, s0, (uu, zz))[0]

    jout = jax.jit(run_jax)(jhs, jnp.asarray(u), jnp.asarray(z))
    want = np.asarray(jout.score)
    s0 = tg.initial_state(b, torch.from_numpy(fo), cfg, "cpu")
    got = tg.nano_game_plain(tg.pack_nano_game(pack, cfg, th), s0, 0,
                             draws=(torch.from_numpy(u), torch.from_numpy(z)),
                             collect_players=True, collect_stats=True)
    assert (got.sec == 0).all()
    same = (got.score.numpy() == want).all(axis=1)
    assert same.mean() >= 0.98, f"{(~same).sum()} of {b} games differ"
    assert 10 < want.mean() < 50
    st, jst = got.stats.numpy()[same], np.asarray(jout.stats)[same]
    ps, jps = got.pstats.numpy()[same], np.asarray(jout.pstats)[same]
    yards = [TS["pass_yds"], TS["rush_yds"]]
    counts = [i for i in range(len(TEAM_STAT_FIELDS)) if i not in yards + [TS["points"]]]
    assert np.array_equal(st[..., counts], jst[..., counts])
    assert np.array_equal(st[..., TS["points"]], want[same].astype(np.float32))
    assert np.allclose(st[..., yards], jst[..., yards], rtol=1e-5, atol=1e-3)
    pcounts = [c for c in range(6) if c != PC_YDS]
    assert np.array_equal(ps[..., pcounts], jps[..., pcounts])
    assert np.allclose(ps[..., PC_YDS], jps[..., PC_YDS], rtol=1e-5, atol=1e-3)
    assert ps[..., PC_ATT].sum() > 0 and st[..., TS["plays"]].sum() > 0


def _nano_th():
    return ttl.pack_tables(*fixtures.nano_tables(TABLE_SEED), device="cpu")


# a small coarse profile for a synthetic play-policy table
SMALL_COARSE = TableProfile(
    dist=np.asarray([0.5, 1.5, 3.0, 6.0, 10.0, 20.0, 64.0]),
    ytg=np.asarray([0.0, 2.0, 6.0, 12.0, 25.0, 50.0, 90.0, 120.0]),
    sec=np.asarray([45.0, 600.0, 1790.0, 2400.0, 3600.0]),
    sd=np.asarray([-8.0, 0.0, 8.0]))


def with_play_table(th, seed: int = 5):
    """th with a play-policy table of random P(pass) in [0.2, 0.8) beside
    its tables: both directions on SMALL_COARSE's cells x the 27 score-diff
    bins of `sd_reps_default`, as `build_play_table` lays it out."""
    cp = ttl.profile_idx(SMALL_COARSE)
    nsd = len(sd_reps_default())
    per_dir = 5 * cp.nd * cp.ny * cp.ns * nsd
    vals = np.random.default_rng(seed).uniform(0.2, 0.8, (2 * per_dir, 1)).astype(np.float32)
    play = ttl.DeviceTable(values=torch.from_numpy(vals),
                           row_map=torch.tensor([[0], [per_dir]], dtype=torch.int32),
                           n_slots=1, profile="play", channels=1, has_sd=True)
    edges = torch.tensor(edges_from_reps(sd_reps_default()), dtype=torch.float32)
    return dataclasses.replace(th, play=play, coarse=cp, play_sd_edges=edges, play_nsd=nsd)


# case: (heads, heads state change, config change, collect_players,
# collect_stats, K1 covers it)
_PLAY = SimConfig().replace(model=dataclasses.replace(
    SimConfig().model, use_play_model=True))
COVER_CASES = {
    "nano_score_only": ("table", {}, None, False, False, True),
    "play_table_unused": ("table", {"play": "play"}, None, False, False, True),
    "play_table_used": ("table", {"play": "play"}, _PLAY, False, False, True),
    "play_model_without_table": ("table", {}, _PLAY, False, False, True),
    "players": ("table", {}, None, True, False, True),
    "box_score": ("table", {}, None, False, True, True),
    "both_collectors": ("table", {}, None, True, True, True),
    "players_play_table_used": ("table", {"play": "play"}, _PLAY, True, False, True),
    "box_score_forced_go": ("table", {}, "go", False, True, True),
    "forced_go": ("table", {}, "go", False, False, True),
    "fused_layout": ("table", {"nano": None, "fused": "fused"}, None, False, False, True),
    "play_table_without_coarse": ("table", {"play": "play", "coarse": None}, _PLAY, False,
                                  False, False),
    "analytic": ("analytic", {}, None, False, False, False),
    "exact": ("exact", {}, None, False, False, False),
}


@pytest.mark.parametrize("case", list(COVER_CASES))
def test_nano_game_covers_exactly_the_score_only_nano_launches(case):
    """K1 takes every table-mode launch: a nano or fused table (the
    per-head tables' cases are tests/test_torch_k1_layouts.py's), with or
    without the play-policy lookup, under any fourth.force, whichever
    collectors the launch asks for (K1 has an instantiation for each);
    exact and analytic heads, and a play table without the coarse profile
    its cells are on, stay on the eager loop.  The collectors decide the
    instantiation, never whether K1 plays.  Where it plays, its plain
    version on the launch's settings gives what the eager loop gives."""
    heads, change, cfg_change, players, stats, covered = COVER_CASES[case]
    cfg = SimConfig()
    if cfg_change == "go":
        cfg = cfg.replace(fourth=dataclasses.replace(cfg.fourth, force="go"))
    elif cfg_change is not None:
        cfg = cfg_change
    th = _nano_th()
    if change.get("play") == "play":
        th = with_play_table(th)
    if change.get("fused") == "fused":
        th = ttl.pack_tables(*fixtures.fused_tables(TABLE_SEED), device="cpu",
                             fused_prof=nano_profile())
    th = dataclasses.replace(th, **{k: v for k, v in change.items()
                                    if v not in ("play", "fused")})
    he = {"table": ttl.make_table_heads_eval, "analytic": tg.make_analytic_heads_eval,
          "exact": tg.make_exact_heads_eval}[heads](cfg)
    hs = th if heads == "table" else None
    assert tg.nano_game_covers(cfg, he, hs) is covered
    if covered:
        pack, _ = _pack_and_tables()
        coll = dict(collect_players=players, collect_stats=stats)
        a, b = (tg.initial_state(8, 0, cfg, "cpu", **coll) for _ in range(2))
        want = tg.simulate_games_eager(pack, cfg, he, hs, 3, 8, 0, init_state=a, **coll)
        got = tg.nano_game(tg.pack_nano_game(pack, cfg, hs), b, 3, **coll)
        for f in FIELDS:
            assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f


def _struct_fields(src: str, name: str):
    """(field, array length or 0) of `struct name` in a CUDA source, in
    order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = " ".join(decl.replace("*", " ").split())
        if not decl:
            continue
        names = decl.removeprefix("const ").split(" ", 1)[1]
        for v in names.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\w+)\])?\s*", v)
            out.append((m.group(1), m.group(2) or 0))
    return out


def test_packed_constants_follow_the_kernel_struct():
    """`NanoConsts` and `_Segs` name the kernel's fields in its order, with
    its array lengths (the launcher checks the total size on the card);
    the defaults pack as the eager loop runs: 360 plays, the padded edges,
    the nano profile's segments; the slot tables stack the pack's in
    pstats' role order (QB, rusher, target), as the kernel reads them."""
    src = (CSRC / "nano_game.cu").read_text()
    consts = {"kSlots": tg._SLOTS, "kSegs": tg._SEGS, "kGridCells": tg._GRID_CELLS}

    def ctypes_fields(cls):
        return [(n, getattr(t, "_length_", 0)) for n, t in cls._fields_]

    consts.update(kPlayEdges=tg._PLAY_EDGES, kHeadTables=len(tg.HEAD_TABLES))
    for cls, name in ((tg.NanoConsts, "NanoConsts"), (tg._Segs, "Segs"),
                      (tg.LayoutConsts, "LayoutConsts"), (tg._HeadTable, "HeadTable")):
        want = [(n, (consts[k] if k in consts else int(k)) if k else 0)
                for n, k in _struct_fields(src, name)]
        assert ctypes_fields(cls) == want, name
    for i, kind in enumerate(tg.LAYOUT_KINDS):
        name = "".join(w.capitalize() for w in kind.split())
        assert re.search(r"kLayout%s = %d" % (name, i), src), kind
    assert "kPlaySdLo = %d, kPlaySdBins = %d" % (tg.PLAY_SD_LO, tg.PLAY_SD_BINS) in src
    assert "kForceGo = %d, kForceFg = %d" % (tg.FORCE_CODES["go"], tg.FORCE_CODES["fg"]) in src
    pack, th = _pack_and_tables()
    args = tg.pack_nano_game(pack, SimConfig(), th)
    c = args.consts
    assert c.cap == 360 and args.early_exit
    assert list(c.go_ytg_edges)[7:] == [float("inf")] and c.go_row == 5
    assert list(c.fg_bounds)[4:] == [float("-inf")] * 4
    assert c.nsd == 3 and c.c == 7 and c.cols == 105 and c.per_dir == 8192
    assert c.dist.enter[0] == float("-inf") and c.dist.enter[5] == float("inf")
    assert c.sec.base[7] == 14 and c.sec.top[7] == 1.0
    assert args.dirs.shape == (2, 5) and args.table is th.nano.values
    assert tg.pack_nano_game(pack, _cfg(play_chunk=32), th).consts.cap == 384
    assert args.kind == 0 and args.table_layout == "nano" and args.play is None
    assert args.k == pack.k == 8 and args.slot_cum.shape == (3, 2, 8)
    assert args.slot_cum.dtype == torch.float32 and args.slot_tracked.dtype == torch.bool
    for r, role in enumerate(("qb", "rb", "wr")):
        assert torch.equal(args.slot_cum[r], getattr(pack, f"{role}_cum"))
        assert torch.equal(args.slot_tracked[r], getattr(pack, f"{role}_tracked"))
    assert "kRoles = 3" in src and "kTeamStats = 19" in src and "kPlayerStats = 6" in src
    assert re.search(r"constexpr int kPoints = %d;" % TS["points"], src)


def _cut(s, a: int, b: int):
    """Games a..b-1 of a GameState."""
    return tg.GameState(*(f[a:b] for f in s))


def _join(parts):
    return tg.GameState(*(torch.cat(fs) for fs in zip(*parts)))


@pytest.mark.parametrize("anti", [False, True], ids=["plain", "antithetic"])
def test_nano_game_games_do_not_depend_on_their_launch(anti):
    """What K1's work queue rests on: each game of a 3-matchup launch,
    played by `nano_game_plain` in a piece of the launch alone at the
    piece's own row offset, ends as it ends in the whole launch, and the
    pieces played in a shuffled order and put back in game order give the
    whole launch on every field.  Antithetic pieces are whole blocks of
    four."""
    cfg = _cfg(antithetic=True) if anti else SimConfig()
    pack, th = _pack_and_tables(3)
    n = 64 * 3
    fo = torch.arange(n, dtype=torch.int32) % 2
    gid = torch.arange(n, dtype=torch.int32) // 64
    s0 = tg.initial_state(n, fo, cfg, "cpu", gid, collect_players=False, collect_stats=False)
    args = tg.pack_nano_game(pack, cfg, th)
    key = root_key(5)
    whole = tg.nano_game_plain(args, s0, key, 0, anti)
    cuts = [0, 20, 88, 132, n]          # ragged pieces across the matchups' edges
    parts = {}
    for k in np.random.default_rng(4).permutation(len(cuts) - 1):
        a, b = cuts[k], cuts[k + 1]
        parts[k] = tg.nano_game_plain(args, _cut(s0, a, b), key, a, anti)
        for f in FIELDS:
            assert torch.equal(getattr(parts[k], f), getattr(_cut(whole, a, b), f)), (a, b, f)
    joined = _join([parts[k] for k in range(len(cuts) - 1)])
    for f in FIELDS:
        assert torch.equal(getattr(joined, f), getattr(whole, f)), f
    assert (whole.sec == 0).all()


def _queue_handout(n: int, blocks: int, threads: int, seed: int):
    """Each game's lane handouts under K1's queue: lane t takes game t,
    then warps whose games end claim popc(ended) games at once from the
    counter, each ended lane taking lanes + base + its rank among them;
    the warps end games in a random order."""
    lanes = blocks * threads
    rng = np.random.default_rng(seed)
    given = list(range(min(n, lanes)))
    games = [list(range(w * 32, w * 32 + 32)) for w in range(lanes // 32)]
    counter = 0
    while True:
        live = [w for w, g in enumerate(games) if any(i < n for i in g)]
        if not live:
            return given
        w = live[rng.integers(len(live))]
        ended = sorted(set(rng.choice(32, rng.integers(1, 33), replace=False)))
        ended = [k for k in ended if games[w][k] < n]
        if not ended:
            continue
        base, counter = counter, counter + len(ended)
        for rank, k in enumerate(ended):
            games[w][k] = lanes + base + rank
            if games[w][k] < n:
                given.append(games[w][k])


@pytest.mark.parametrize("n,resident,blocks", [(100, 792, 1), (1_000, 792, 8),
                                               (65_536, 792, 512), (1_966_080, 792, 792),
                                               (4, 1_188, 1)])
def test_nano_grid_and_queue_cover_every_game_once(n, resident, blocks):
    """K1's persistent grid: no more blocks than the card holds at once,
    none that n games leave empty; the queue over that grid hands every
    game out exactly once (counted here at the small sizes)."""
    assert tg.nano_grid(n, resident, 128) == blocks
    if n <= 2_000:
        given = _queue_handout(n, blocks, 128, seed=n)
        assert sorted(given) == list(range(n))
    assert tg.nano_grid(0, resident, 128) == 1
    assert tg.nano_grid(n, resident, 64) == min(resident, -(-n // 64))


@pytest.mark.parametrize("n,groups", [(100, 1), (3_001, 5), (32_768, 60), (0, 2)])
def test_moments_grid_covers_every_game_once(n, groups):
    """K2's geometry: a cluster of _CLUSTER blocks a matchup, its blocks'
    strides covering each of the matchup's games exactly once, with n
    under one block and n ragged; past the grid's y extent it raises."""
    (gx, gy), cluster, threads = tagg.moments_grid(groups)
    assert (gx, gy, cluster, threads) == (tagg._CLUSTER, groups, tagg._CLUSTER, tagg._THREADS)
    seen = np.zeros(n, dtype=np.int64)
    for r in range(cluster):
        for t in range(threads):
            seen[r * threads + t:n:cluster * threads] += 1
    assert (seen == 1).all()
    with pytest.raises(ValueError, match="65,535"):
        tagg.moments_grid(65_536)


_CTYPES = {"int": ctypes.c_int, "uint32_t": ctypes.c_uint32}


def _launcher_params(src: str, name: str):
    """The ctypes type of each parameter of `extern "C" int name(...)` in a
    CUDA source: pointers of any kind a c_void_p."""
    body = re.search(r'extern "C" int %s\((.*?)\)' % name, src, re.S).group(1)
    out = []
    for decl in body.split(","):
        decl = " ".join(decl.split())
        ctype = decl.rsplit(" ", 1)[0]
        out.append(ctypes.c_void_p if "*" in decl else _CTYPES[ctype])
    return out


def _constant(src: str, name: str) -> int:
    return int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))


def test_launchers_follow_the_kernel_sources():
    """The wrappers' argtypes are the launchers' parameters in the .cu
    files, in order; K2's block and cluster sizes are the kernel's (K1's
    the wrapper asks the library), and K1's library exports its queries."""
    nano = (CSRC / "nano_game.cu").read_text()
    moments = (CSRC / "score_moments.cu").read_text()
    assert _launcher_params(nano, "nano_game_launch") == tg._NANO_ARGTYPES
    assert _launcher_params(moments, "score_moments_launch") == tagg._MOMENTS_ARGTYPES
    assert _constant(moments, "kThreads") == tagg._THREADS
    assert _constant(moments, "kCluster") == tagg._CLUSTER
    for fn in ("nano_game_threads", "nano_game_consts_size", "nano_game_layout_size"):
        assert f'extern "C" int {fn}()' in nano
    # the occupancy of the instantiation for (layout, collect_stats,
    # collect_players) with the slot tables it stages
    assert _launcher_params(nano, "nano_game_blocks_per_sm") == [ctypes.c_int] * 4


def test_moments_dispatch_on_the_cpu():
    """`exact_moments` on CPU scores is its torch body (K2 is for the card),
    with leading axes and with no games."""
    rng = np.random.default_rng(3)
    sc = torch.from_numpy(rng.integers(-5, 140, (2, 3, 50, 2)).astype(np.int32))
    for x in (sc, sc[0, 0], sc[:, :, :0]):
        for a, b in zip(tagg.exact_moments(x), tagg.exact_moments_plain(x)):
            assert torch.equal(a, b)
    assert tagg.exact_moments_cuda.launches == 0


def test_cuda_request_without_cuda_raises():
    """Without a card, K1's and K2's launch paths raise instead of running
    anything on the CPU, and count no launch; a runner asked for the card
    raises too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    pack, th = _pack_and_tables()
    cfg = SimConfig()
    s0 = tg.initial_state(8, 0, cfg, "cpu", collect_players=False, collect_stats=False)
    with pytest.raises(ValueError, match="CUDA"):
        tg.nano_game_cuda(tg.pack_nano_game(pack, cfg, th), s0, 1)
    with pytest.raises(ValueError, match="on the card"):
        tagg.exact_moments_cuda(s0.score)
    assert tg.nano_game_cuda.launches == 0 and tagg.exact_moments_cuda.launches == 0
    a, b = fixtures.teams()
    with pytest.raises(RuntimeError):
        MatchupRunner(a, b, None, cfg, mode="table",
                      nano_tables=fixtures.nano_tables(TABLE_SEED), device="cuda")


def test_smoke_bounds_of_k1_and_k2():
    """chip_smoke's bounds of the two kernels: K1 by dispatch at the main
    path's plays (its state and table bytes far under), K2 by its bytes;
    every class counted, none above dispatch."""
    import chip_smoke

    clock = 132 * 1.98e9
    plays = 10_723_604            # 163.6 plays a game at 65,536 games
    b = chip_smoke.nano_bound(65_536, plays, 16_384 * 105 * 4)
    assert (b["bound_class"], b["bound_by"]) == ("dispatch", "operations")
    assert b["bound_ms"] == pytest.approx(
        plays * chip_smoke.NANO_COUNTS["dispatch"] / (128 * clock) * 1e3)
    m = chip_smoke.moment_bound(60, 32_768)
    assert (m["bound_class"], m["bound_by"]) == ("bytes", "bytes")
    assert m["bound_ms"] == pytest.approx((60 * 32_768 * 8 + 60 * (8 * 8 + 768 * 4))
                                          / 3.35e12 * 1e3)
    for c in (chip_smoke.NANO_COUNTS, chip_smoke.MOMENT_COUNTS):
        assert set(c) == set(chip_smoke.RATES) - {"bytes"}
        assert c["alu"] + c["imad"] + c["mufu_cvt"] <= c["dispatch"]
    assert {"nano_game", "score_moments"} <= set(chip_smoke.KERNEL_SOURCES)
    assert all(name in chip_smoke.REPLACES for name in chip_smoke.KERNEL_SOURCES)


def test_smoke_bound_of_k1_props():
    """chip_smoke's bound of K1's props instantiation: the score-only
    bound's work plus the collectors' (the team stats a play, a count a
    slot sampled and a player row added, the stats and the touched player
    rows read and written once), the work read off a launch's box score
    and player stats by `accrual_work`; every class counted, none above
    dispatch."""
    import chip_smoke

    pack, th = _focus_pack("focus", None)[:2]
    cfg = SimConfig()
    coll = dict(collect_players=True, collect_stats=True)
    n = 64
    s0 = tg.initial_state(n, torch.arange(n, dtype=torch.int32) % 2, cfg, "cpu", **coll)
    out = tg.nano_game_plain(tg.pack_nano_game(pack, cfg, th), s0, root_key(2), **coll)
    work = chip_smoke.accrual_work(out)
    st = out.stats
    pass_plays = float((st[..., TS["pass_att"]] + st[..., TS["sacks"]]).sum())
    assert work["sampled"] == 2 * pass_plays + float(st[..., TS["rush_att"]].sum()) > 0
    # every player row added holds one attempt (target, carry) or one QB
    # attempt or sack, on a tracked slot
    assert 0 < work["rows_touched"] <= work["rows_added"] <= work["sampled"]
    assert work["stats_bytes"] == n * 2 * 19 * 4
    plays = 160 * n
    base = chip_smoke.nano_bound(n, plays, 1_000)
    props = chip_smoke.nano_bound(n, plays, 1_000, work)
    assert props["bound_ms"] > base["bound_ms"] and props["bound_class"] == "dispatch"
    counts = {k: chip_smoke.NANO_COUNTS[k] * plays + chip_smoke.NANO_TEAM_COUNTS[k] * plays
              + chip_smoke.NANO_SLOT_COUNTS[k] * work["sampled"]
              + chip_smoke.NANO_ROW_COUNTS[k] * work["rows_added"] for k in chip_smoke.NANO_COUNTS}
    assert props["bound_ms"] == pytest.approx(
        counts["dispatch"] / chip_smoke.RATES["dispatch"] * 1e3)
    for c in (chip_smoke.NANO_TEAM_COUNTS, chip_smoke.NANO_SLOT_COUNTS,
              chip_smoke.NANO_ROW_COUNTS):
        assert set(c) == set(chip_smoke.RATES) - {"bytes"}
        assert c["alu"] + c["imad"] + c["mufu_cvt"] <= c["dispatch"]
    assert chip_smoke.KERNEL_SOURCES["nano_game_props"] == "nano_game"
    assert "nano_game_props" in chip_smoke.REPLACES
