"""K1 (`ops/game.nano_game`) on every table-mode launch, on the CPU: the
fused and per-head layouts, the play-policy table and the forced first
play of the 4th-down evaluator.

The kernel runs only on the card (`chip_smoke.py` phase 21 holds it to the
eager loop and to its plain version there).  Here its plain version,
`nano_game_plain`, which reads exactly the packed inputs the launcher
passes (`pack_nano_game`), is held bit for bit to the eager game loop
(`simulate_games_eager`) on every GameState field, the box score and the
player stats included: fused tables on the coarse, turbo and slate
profiles, per-head tables of a focus roster on small and on the default
profiles, the play table beside nano, fused and per-head tables, each
forced 4th-down choice with and without antithetic draws, resumed
states, and each collector alone from a late start in ragged and
antithetic launches.  The tables are `tests/test_torch_table_layouts.py`'s (`LAYOUTS`,
built from `fixtures.heads(13, "small")`).  A forced first play on
injected draws is held to the JAX package's `play_step` under
fourth.force, integer state equal in at least 98% of rows, as the table
layouts' own play step is.  The 4th-down evaluator's forced choice, now
one launch, gives what its eager composition gave."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu.ops import game as jg
from fast_monte_carlo_tpu.ops import table_lookup as jtl
from fast_monte_carlo_tpu_torch import api, fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.matchup import build_direction
from fast_monte_carlo_tpu_torch.models import tables as tt
from fast_monte_carlo_tpu_torch.ops import game as tg
from fast_monte_carlo_tpu_torch.ops import table_lookup as ttl
from fast_monte_carlo_tpu_torch.ops.pack import pack_matchup
from fast_monte_carlo_tpu_torch.ops.rng import fold_in, root_key, step_draws

from test_torch_nano_game import FIELDS, _bits, with_play_table
from test_torch_support import (TABLE_SEED, jax_pack, jax_state, port_pack, port_state,
                                row_mismatch)
from test_torch_support import table_cache_off  # noqa: F401 (autouse)
from test_torch_table_layouts import CM, HEADS_SEED, LAYOUTS, _layout_heads, env  # noqa: F401

torch.set_num_threads(1)

N = 256
BOTH = dict(collect_players=True, collect_stats=True)
SCORE_ONLY = dict(collect_players=False, collect_stats=False)
# a 4th-and-2 at midfield, 25:00 left, 10-14: the evaluator's kind of start
FOURTH = tg.Situation(0, 1500, 4, 2.0, 45.0, 10, 14)
# Q4 10:00, 1st-and-10 at the 25, 21-17: a short rest of a game
Q4_LATE = tg.Situation(0, 600, 1, 10.0, 75.0, 21, 17)


def _clone(s):
    return tg.GameState(*(f.clone() for f in s))


def _port_layout(env, layout, teams=None):
    """(pack, TableHeads, config) of a LAYOUTS entry, the port's build
    alone, with the pack of its teams (or of `teams`, an `env` entry) and
    heads."""
    own, kw, model = LAYOUTS[layout]
    teams = teams or own
    model = dict(model)
    sd_mode = model.pop("sd_mode", "axis")
    cfg = SimConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model),
                      engine=dataclasses.replace(cfg.engine, sd_mode=sd_mode, cachewarm_games=8))
    h = env["heads"]
    if layout.endswith("no_stage2"):
        h = dataclasses.replace(h, stage2=None)
    a, b = env[teams][0]
    th = ttl.build_table_heads(a, b, h, cfg, CM, device="cpu", **kw)
    pack = pack_matchup(build_direction(a, b, cfg, h, CM), build_direction(b, a, cfg, h, CM),
                        "cpu")
    return pack, th, cfg


def _same(got, want):
    for f in FIELDS:
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f
        assert getattr(got, f).dtype == getattr(want, f).dtype, f


def _held_to_eager(pack, th, cfg, coll, n=N, force=None, situation=None, init_state=None,
                   key=None):
    """`nano_game` on the CPU (its plain version on `pack_nano_game`'s
    inputs) against `simulate_games_eager` from the same start, bit for
    bit on every field; returns (the games, the packed inputs)."""
    key = root_key(37) if key is None else key
    fk = fold_in(key, api.FORCED_PLAY_STREAM) if force else None
    fo = torch.arange(n, dtype=torch.int32) % 2
    he = ttl.make_table_heads_eval(cfg)
    assert tg.nano_game_covers(cfg, he, th)
    start = dict(situation=situation,
                 init_state=None if init_state is None else _clone(init_state))
    want = tg.simulate_games_eager(pack, cfg, he, th, key, n, fo, first_play_force=force,
                                   first_play_key=fk, **coll, **start)
    s, cfg2, anti = tg._launch_state(pack, cfg, n, fo, coll["collect_players"], 0,
                                     coll["collect_stats"], situation,
                                     None if init_state is None else _clone(init_state), 0,
                                     None)
    args = tg.pack_nano_game(pack, cfg2, th)
    got = tg.nano_game(args, s, key, 0, anti, force=force, force_key=fk, **coll)
    _same(got, want)
    assert tg.nano_game_cuda.launches == 0
    return got, args


LAYOUT_CASES = ["fused_coarse", "turbo", "slate", "fused_play", "nano_play", "per_head",
                "per_head_no_stage2", "per_head_slate", "per_head_cachewarm"]


@pytest.mark.parametrize("collectors", ["score_only", "both"])
@pytest.mark.parametrize("layout", LAYOUT_CASES)
def test_plain_equals_eager_on_each_layout(env, layout, collectors):
    """Fused tables on the coarse, turbo and slate profiles (with the play
    table beside the turbo one), the nano table with the play table, and
    per-head tables of the focus roster (with the play table and fumbles,
    without stage 2, on profiles without a score-diff axis, collapsed in
    'cachewarm'): K1's plain version plays the eager loop's games bit for
    bit, score-only and with both collectors, in the instantiation the
    layout takes."""
    pack, th, cfg = _port_layout(env, layout)
    coll = BOTH if collectors == "both" else SCORE_ONLY
    got, args = _held_to_eager(pack, th, cfg, coll)
    want_layout = ("per_head" if th.stage1 is not None else
                   "fused" if th.fused is not None else "nano")
    assert args.table_layout == want_layout
    assert tg.LAYOUT_KINDS[args.kind] == {"per_head": "heads", "fused": "row",
                                          "nano": "row"}[want_layout]
    assert (args.play is not None) == (th.play is not None and cfg.model.use_play_model)
    assert (got.sec == 0).all() and 5 < float(got.score.float().mean()) < 45
    if coll is BOTH:
        assert float(got.stats.abs().sum()) > 0


@pytest.fixture(scope="module")
def default_focus(env):
    """The focus roster's per-head tables on the default fine and coarse
    profiles (what `simulate_upcoming_matchup` builds for it in table
    mode), with the play table and fumbles."""
    cfg = SimConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_play_model=True,
                                                enable_fumbles=True))
    (a, b), _ = env["focus"]
    h = env["heads"]
    th = ttl.build_table_heads(a, b, h, cfg, CM, nano=tt.nano_profile(), device="cpu")
    pack = pack_matchup(build_direction(a, b, cfg, h, CM), build_direction(b, a, cfg, h, CM),
                        "cpu")
    return pack, th, cfg


@pytest.mark.parametrize("collectors", ["score_only", "both"])
def test_plain_equals_eager_on_default_profiles(default_focus, collectors):
    """Per-head tables of the focus roster on the default profiles (fine
    47 x 121 x 61 x 7, coarse 35 x 79 x 41 x 3: the segments K1 bins by,
    its 8 a profile axis): bit for bit, score-only and with both
    collectors."""
    pack, th, cfg = default_focus
    assert th.nano is None and th.stage1.n_slots > 1 and th.fine.nd == 47
    got, args = _held_to_eager(pack, th, cfg, BOTH if collectors == "both" else SCORE_ONLY,
                               n=128)
    assert args.layout.nd1 == 47 and args.layout.nd2 == 35 and args.layout.has_play


@pytest.mark.parametrize("anti", [False, True], ids=["plain", "antithetic"])
@pytest.mark.parametrize("force", ["go", "fg", "punt"])
@pytest.mark.parametrize("layout", ["nano", "per_head"])
def test_forced_first_play_equals_the_eager_composition(env, layout, force, anti):
    """The forced first play in K1's launch (FORCE_CODES on the forced
    stream's row, outside the cap, then the plays from step 0 of the launch
    key) gives the eager composition's games bit for bit: one `play_step`
    under fourth.force on step 0 of the forced key, then the eager loop,
    from a 4th-and-2; on the nano table score-only and on the focus
    roster's per-head tables with both collectors."""
    if layout == "nano":
        pack, _ = _nano_pack()
        th, cfg, coll = ttl.pack_tables(*fixtures.nano_tables(TABLE_SEED), device="cpu"), \
            SimConfig(), SCORE_ONLY
    else:
        pack, th, cfg = _port_layout(env, "per_head")
        coll = BOTH
    if anti:
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=True))
    got, args = _held_to_eager(pack, th, cfg, coll, force=force, situation=FOURTH)
    assert args.layout.force_every == 0 and (got.sec == 0).all()


def _nano_pack():
    cfg = SimConfig()
    a, b = fixtures.teams()
    return pack_matchup(build_direction(a, b, cfg), build_direction(b, a, cfg), "cpu"), cfg


@pytest.mark.parametrize("force", [None, "punt"], ids=["unforced", "forced_punt"])
def test_resumed_state_equals_eager(env, force):
    """From a state resumed after 30 eager plays with both collectors on
    (stats and player rows nonzero), on the focus roster's per-head tables:
    bit for bit, unforced and with a forced first play."""
    pack, th, cfg = _port_layout(env, "per_head")
    he = ttl.make_table_heads_eval(cfg)
    s = tg.initial_state(N, torch.arange(N, dtype=torch.int32) % 2, cfg, "cpu", 0, pack.k)
    for j in range(30):
        s = tg.play_step(s, step_draws(fold_in(root_key(3), 7), j, N, "cpu"), pack, cfg, he,
                         th, True, True)
    assert float(s.stats.abs().sum()) > 0 and float(s.pstats.abs().sum()) > 0
    _held_to_eager(pack, th, cfg, BOTH, force=force, init_state=s)


@pytest.mark.parametrize("anti", [False, True], ids=["plain_37", "antithetic_4"])
@pytest.mark.parametrize("collector", ["box_score", "player_stats"])
@pytest.mark.parametrize("layout", ["fused_coarse", "per_head"])
def test_one_collector_from_a_late_start_equals_eager(env, layout, collector, anti):
    """Each collector alone (the box score, the player stats), on fused and
    per-head tables of the focus roster (whose tracked slots give nonzero
    player rows), from Q4 10:00 at 21-17, in a launch of 37 games (not a
    warp's multiple) and of 4 with antithetic draws: bit for bit, and what
    the collector gathers is nonzero."""
    pack, th, cfg = _port_layout(env, layout, teams="focus")
    if anti:
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=True))
    players = collector == "player_stats"
    coll = dict(collect_players=players, collect_stats=not players)
    got, _ = _held_to_eager(pack, th, cfg, coll, n=4 if anti else 37, situation=Q4_LATE)
    assert float((got.pstats if players else got.stats).abs().sum()) > 0


def test_every_play_forced_equals_eager():
    """fourth.force in the config forces every play's 4th-down decision
    (force_every), on the nano table beside a play table and on the
    one-row instantiation: bit for bit with both collectors."""
    pack, cfg = _nano_pack()
    cfg = cfg.replace(fourth=dataclasses.replace(cfg.fourth, force="go"),
                      model=dataclasses.replace(cfg.model, use_play_model=True))
    th = with_play_table(ttl.pack_tables(*fixtures.nano_tables(TABLE_SEED), device="cpu"))
    got, args = _held_to_eager(pack, th, cfg, BOTH)
    assert args.layout.force_every == tg.FORCE_CODES["go"] and tg.LAYOUT_KINDS[args.kind] == "row"
    assert float(got.stats[..., 15].sum()) > 0      # fourth_go


@pytest.mark.parametrize("force", ["go", "fg", "punt"])
@pytest.mark.parametrize("layout", ["per_head", "nano_play"])
def test_forced_play_matches_jax_on_injected_draws(env, layout, force):
    """One forced play of `nano_game_plain` (its draws given, no play
    after it) against the JAX package's `play_step` under fourth.force on
    the same states and draws: integer state equal in at least 98% of
    rows, yardages close where it is (the standard of the table layouts'
    play step, tests/test_torch_table_layouts.py)."""
    th, jth, cfg, jcfg = _layout_heads(env, layout)
    cfg = cfg.replace(fourth=dataclasses.replace(cfg.fourth, force=None))
    jcfg_f = jcfg.replace(fourth=dataclasses.replace(jcfg.fourth, force=force))
    focus = env["focus_csv"] if LAYOUTS[layout][0] == "focus" else None
    jpack = jax_pack(jcfg, focus_csv=focus)
    pack = port_pack(jpack)
    rng = np.random.default_rng(19)
    n = 4096
    d = fixtures.play_states(rng, n)
    d["down"][: n // 2] = 4                 # half the rows face a 4th down
    u, z = fixtures.play_draws(rng, (n,))
    jout = jax.jit(lambda s, hs: jg.play_step(
        s, None, jpack, jcfg_f, jtl.make_table_heads_eval(jcfg_f), hs, False, False,
        draws=(jnp.asarray(u), jnp.asarray(z))))(jax_state(d), jth)
    args = tg.pack_nano_game(pack, cfg, th)
    empty = (torch.empty((0, n, 13)), torch.empty((0, n, 4)))
    out = tg.nano_game_plain(args, port_state(d), 0, draws=empty, force=force,
                             force_draws=(torch.from_numpy(u), torch.from_numpy(z)))
    bad = row_mismatch(jout, out)
    assert bad.mean() <= 0.02, f"{bad.sum()} of {bad.size} rows differ"
    for f in ("dist", "ytg"):
        np.testing.assert_allclose(getattr(out, f).numpy()[~bad],
                                   np.asarray(getattr(jout, f))[~bad], rtol=1e-5, atol=1e-4)
    kicked = (d["down"] == 4) & (d["sec"] > 0)
    if force in ("fg", "punt"):      # every active 4th down kicks: a new series follows
        assert (out.down.numpy()[kicked] == 1).all() and kicked.sum() > 100


@pytest.mark.parametrize("case", ["per_head", "per_head_without_coarse"])
def test_nano_game_covers_per_head_tables(env, case):
    """K1 takes the per-head layout (stage 1, the quantile tables and both
    profiles present); without the coarse profile its play lookup and the
    coarse heads have no cells, so that launch stays on the eager loop."""
    _, th, cfg = _port_layout(env, "per_head")
    if case == "per_head_without_coarse":
        th = dataclasses.replace(th, coarse=None)
    assert tg.nano_game_covers(cfg, ttl.make_table_heads_eval(cfg), th) is (case == "per_head")


def test_fourth_decision_is_one_launch_of_its_composition():
    """`run_fourth_decision`'s forced choices now run as one launch
    (`simulate_games(first_play_force=)`): each choice's moments equal the
    old eager composition's (one forced `play_step` on step 0 of
    fold_in(chunk key, FORCED_PLAY_STREAM), then `simulate_games` from the
    result), bit for bit, plain and antithetic."""
    a, b = fixtures.teams()
    tables = fixtures.nano_tables(TABLE_SEED)
    for anti in (False, True):
        cfg = SimConfig().replace(engine=dataclasses.replace(SimConfig().engine,
                                                             antithetic=anti))
        r = api.MatchupRunner(a, b, None, cfg, mode="table", nano_tables=tables, device="cpu")
        n = 512
        got = r.run_fourth_decision(FOURTH, n_games=n, seed=4, chunk_games=n)
        key = fold_in(root_key(4), 0)
        for choice in ("go", "fg", "punt"):
            cfg_f = cfg.replace(fourth=dataclasses.replace(cfg.fourth, force=choice))
            init = tg.state_from_situation(n, FOURTH, cfg, "cpu", 0, r.pack.k,
                                           collect_players=False, collect_stats=False)
            rows = n // 2 if anti else n
            init = tg.play_step(init, step_draws(fold_in(key, api.FORCED_PLAY_STREAM), 0, rows,
                                                 "cpu"), r.pack, cfg_f, r.heads_fn,
                                r.heads_state)
            out = tg.simulate_games(r.pack, cfg, r.heads_fn, r.heads_state, key, n, 0,
                                    collect_players=False, collect_stats=False,
                                    situation=FOURTH, init_state=init)
            want = api.summary_from_moments(api.score_moments(out.score))
            for f in got[choice]._fields:
                assert torch.equal(getattr(got[choice], f), getattr(want, f)), (choice, f)


def test_smoke_bounds_of_k1_layouts(env):
    """chip_smoke's bound of a K1 launch on any layout (`layout_bound`):
    on the nano table it is `nano_bound`'s; a layout's counts replace the
    nano profile's binning with its own and add its lookups (the play
    table's 26-edge search, the per-head slots and tables), every class at
    or under dispatch; the focus roster's default-profile per-head tables,
    larger than the L2, are read a sector a lookup."""
    import chip_smoke as cs

    pack, cfg = _nano_pack()
    th = ttl.pack_tables(*fixtures.nano_tables(TABLE_SEED), device="cpu")
    nano = tg.pack_nano_game(pack, cfg, th)
    plays = 10_723_604
    assert cs.layout_counts(nano) == cs.NANO_COUNTS
    assert cs.layout_bound(nano, 65_536, plays) == cs.nano_bound(65_536, plays,
                                                                 th.nano_values.numel() * 4)
    pcfg = cfg.replace(model=dataclasses.replace(cfg.model, use_play_model=True))
    play = tg.pack_nano_game(pack, pcfg, with_play_table(th))
    hpack, hth, hcfg = _port_layout(env, "per_head")
    heads = tg.pack_nano_game(hpack, hcfg, hth)
    for args in (play, heads):
        counts = cs.layout_counts(args)
        assert counts["dispatch"] > cs.NANO_COUNTS["dispatch"]
        assert counts["alu"] + counts["imad"] + counts["mufu_cvt"] <= counts["dispatch"]
    assert (cs.layout_counts(play)["alu"] - cs.NANO_COUNTS["alu"]
            >= cs.PLAY_SEARCH_COUNTS["alu"])
    # small tables are read once; past the L2, a sector a lookup a play
    read = [t for i, t in enumerate(heads.heads)
            if t is not None and (i != 5 or heads.layout.use_fumble)]
    assert heads.play is not None and len(read) == 6
    assert cs.table_read_bytes(heads, plays) == heads.play.numel() * 4 + sum(
        v.numel() * 4 + m.numel() * 4 for v, m in read)
    wide = torch.zeros(1, 1).expand(2 ** 24, 1)     # 64 MB of values, no memory taken
    big = heads._replace(heads=tuple(None if t is None else (wide, t[1]) for t in heads.heads))
    assert cs.table_read_bytes(big, plays) == (heads.play.numel() * 4
                                               + plays * len(read) * cs.SECTOR_BYTES)
