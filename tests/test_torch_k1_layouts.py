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
one launch, gives what its eager composition gave.  What K1 computes once
a block or a game for the one-row layouts (the play table's score-diff
bins, each direction's first rows) and the packed lookups built on them
are held to the JAX package's `_bin` and play-table lookup, and each
launch to the instantiation it takes."""
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
from test_torch_table_layouts import (CM, HEADS_SEED, LAYOUTS, _layout_heads,  # noqa: F401
                                      _obs_fields, env)

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
    table's coarse cell and score-diff bin, the least any binning of an
    integer among its 26 edges needs: a clamp and a load; the per-head
    slots and tables), every class at or under dispatch; the focus roster's default-profile per-head tables,
    larger than the L2, are read a sector a lookup."""
    import chip_smoke as cs

    pack, cfg = _nano_pack()
    th = ttl.pack_tables(*fixtures.nano_tables(TABLE_SEED), device="cpu")
    nano = tg.pack_nano_game(pack, cfg, th)
    plays = 10_723_604
    assert cs.PLAY_SEARCH_COUNTS == {"alu": 2, "imad": 0, "mufu_cvt": 0, "dispatch": 3}
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
    coarse = cs.bin_counts([sum(1 for e in g.enter if e != float("inf"))
                            for g in (play.layout.dist2, play.layout.ytg2, play.layout.sec2)])
    for k, v in cs.layout_counts(play).items():
        assert v == cs.NANO_COUNTS[k] + coarse[k] + cs.PLAY_SEARCH_COUNTS[k], k
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


# edges of the play table's score diff: the default ones (halves and
# integers: -29.5, -23, -21, .., 23, 29.5) and a set at the table's ends
# with integers and halves side by side, unsorted
PLAY_EDGES = {"default": tt.edges_from_reps(tt.sd_reps_default()),
              "integers_and_halves": np.asarray([126.5, -128.0, -99.5, -7.0, -6.5, 0.0, 0.5,
                                                 1.0, 13.5, 42.0, 126.0, float("inf")])}


@pytest.mark.parametrize("edges", list(PLAY_EDGES))
def test_play_sd_bins_equal_jax_bin(edges):
    """The play table's score-diff bins K1 builds once a block
    (`play_sd_bins`, read through `play_sd_bin`'s clamp) give every integer
    score diff in [-200, 200] the JAX package's `_bin`, ties included."""
    e = PLAY_EDGES[edges].astype(np.float32)
    sd = np.arange(-200, 201, dtype=np.int32)
    want = np.asarray(jtl._bin(jnp.asarray(sd, jnp.float32), jnp.asarray(e)))
    bins = tg.play_sd_bins(torch.from_numpy(e))
    assert bins.shape == (tg.PLAY_SD_BINS,) and bins.dtype == torch.int32
    np.testing.assert_array_equal(tg.play_sd_bin(torch.from_numpy(sd), bins).numpy(), want)
    assert want.min() == 0 and want.max() == np.isfinite(e).sum()


@pytest.mark.parametrize("edge", [-128.5, 127.0, 300.0])
def test_pack_refuses_play_edges_past_the_bins(edge):
    """A finite play-table edge outside [PLAY_SD_LO, PLAY_SD_LO +
    PLAY_SD_BINS - 1), where a clamped score diff would take another bin
    than its own, is refused when K1's inputs are packed."""
    pack, cfg = _nano_pack()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_play_model=True))
    th = with_play_table(ttl.pack_tables(*fixtures.nano_tables(TABLE_SEED), device="cpu"))
    e = th.play_sd_edges.clone()
    e[-1] = edge
    with pytest.raises(ValueError, match="edges"):
        tg.pack_nano_game(pack, cfg, dataclasses.replace(th, play_sd_edges=e))
    assert tg.pack_nano_game(pack, cfg, th).layout.has_play


@pytest.mark.parametrize("layout", ["nano_play", "fused_play", "per_head"])
def test_direction_bases_and_play_lookup_equal_jax(env, layout):
    """Each direction's first rows (`direction_bases`: what a lane of the
    one-row layouts takes with its game) are the JAX lookups' (the nano and
    fused row dirx * per_dir; the play table's dirx * its rows a direction,
    or the per-head play row map's entry), and the packed lookups built on
    them and on the score-diff bins give the JAX package's P(pass) of the
    play table bit for bit (table_lookup.py:588-597, :627-639), and on the
    one-row layouts its row's channels, at play_states rows, states at and
    past every grid edge and score diffs past the bins' ends."""
    th, jth, cfg, jcfg = _layout_heads(env, layout)
    jpack = jax_pack(jcfg, focus_csv=env["focus_csv"] if LAYOUTS[layout][0] == "focus" else None)
    args = tg.pack_nano_game(port_pack(jpack), cfg, th)
    rows, play = tg.direction_bases(args)
    dirx = torch.arange(2)
    if args.table_layout == "per_head":
        assert torch.equal(play, torch.from_numpy(np.array(jth.play.row_map)).reshape(-1))
        assert not rows.any()
    else:
        assert torch.equal(rows, dirx.int() * args.consts.per_dir)
        per_dir_p = jth.play.values.shape[0] // jth.play.row_map.size
        assert torch.equal(play, dirx.int() * per_dir_p)
    fields = _obs_fields(9, 3000)
    far = np.asarray([-300.0, -200.0, -129.0, -128.0, 127.0, 128.0, 200.0], np.float32)
    k = far.size
    fields = {f: np.concatenate([v, v[:k]]) for f, v in fields.items()}
    fields["sd"][-k:] = far
    jobs = jg.StepObs(x=None, **{f: jnp.asarray(v) for f, v in fields.items()})
    want = jax.jit(lambda t, o: jtl.make_table_heads_eval(jcfg)(t, o, jpack))(jth, jobs)
    n = fields["sd"].size
    got = tg._packed_heads(args, torch.from_numpy(fields["dirx"]),
                           torch.from_numpy(fields["sd"].astype(np.int32)),
                           torch.from_numpy(fields["down"]), torch.from_numpy(fields["dist"]),
                           torch.from_numpy(fields["ytg"]), torch.from_numpy(fields["sec"]),
                           torch.zeros(n, 13))
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want.p_pass_ml))
    assert float(got[-1].std()) > 0
    if args.table_layout != "per_head":
        p_c, pass_ms, rush_ms, sack_ms = got[:4]
        for g, w in ((p_c, want.p_complete), (pass_ms, want.pass_ms), (rush_ms, want.rush_ms),
                     (sack_ms, want.sack_ms)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_each_launch_takes_its_instantiation(env):
    """`nano_kind`: the nano layout stays nano; a score-only one-row launch
    with neither the play table nor a forced first play (fused tables,
    fourth.force on every play) takes 'row bare', with the play table 'row
    play', with a forced first play 'row forced'; with both, or with a
    collector, the general 'row'; per-head tables 'heads'; the analytic
    heads 'analytic', forced or with a collector too.  Every kind it gives
    is one of the kernel's instantiations (NANO_INSTANTIATIONS)."""
    pack, cfg = _nano_pack()
    nano_th = ttl.pack_tables(*fixtures.nano_tables(TABLE_SEED), device="cpu")
    fused_th = ttl.pack_tables(*fixtures.fused_tables(TABLE_SEED), device="cpu",
                               fused_prof=tt.nano_profile())
    pcfg = cfg.replace(model=dataclasses.replace(cfg.model, use_play_model=True))
    ecfg = cfg.replace(fourth=dataclasses.replace(cfg.fourth, force="go"))
    hpack, hth, hcfg = _port_layout(env, "per_head")
    packed = {"nano": tg.pack_nano_game(pack, cfg, nano_th),
              "fused": tg.pack_nano_game(pack, cfg, fused_th),
              "play": tg.pack_nano_game(pack, pcfg, with_play_table(nano_th)),
              "every": tg.pack_nano_game(pack, ecfg, nano_th),
              "heads": tg.pack_nano_game(hpack, hcfg, hth),
              "analytic": tg.pack_nano_game(pack, cfg, None)}
    box = dict(collect_stats=True)
    cases = [("nano", None, {}, "nano"), ("nano", "go", {}, "row forced"),
             ("nano", "fg", box, "row"), ("nano", None, box, "nano"),
             ("fused", None, {}, "row bare"), ("fused", "punt", {}, "row forced"),
             ("fused", None, dict(collect_players=True), "row"),
             ("play", None, {}, "row play"), ("play", "go", {}, "row"),
             ("play", None, box, "row"), ("every", None, {}, "row bare"),
             ("heads", None, {}, "heads"), ("heads", "go", {}, "heads"),
             ("analytic", None, {}, "analytic"), ("analytic", "go", box, "analytic")]
    for what, force, coll, want in cases:
        kind = tg.nano_kind(packed[what], force, **coll)
        assert tg.LAYOUT_KINDS[kind] == want, (what, force, coll)
        inst = (kind, coll.get("collect_stats", False), coll.get("collect_players", False))
        assert inst in tg.NANO_INSTANTIATIONS, (what, force, coll)
    assert len(set(tg.NANO_INSTANTIATIONS)) == 23

