"""K1's exact instantiation walks only the forests each play reads, on the CPU.

The kernel walks a play's forests in phases (`ops/game.EXACT_LISTS`): the
play head on the scrimmage plays; stage 1 and stage 2 on the passes, the
rush trio and the fumble head on the runs; the pass trio on the
completions, the sack trio on the sacks.  Its plain twin,
`game.exact_heads_read`, names the rows of each head by the same rule.  Here
(the kernel runs only on the card, where `chip_smoke.py` phases 12 and 21
hold it to the eager loop and to `nano_game_plain`):
(a) every head the twin marks unread is replaced by finite values of
another seed, in `nano_game_plain` and in the port's eager exact step, and
both play the unpoisoned games bit for bit, box score and player stats
included, from kickoff, midgame, 4th-and-short, red-zone and end-of-half
states, with and without the play head, stage 2 and the fumble head;
(b) the same rule holds for the JAX package's exact `play_step` on one draw
table: its integer state, unread heads poisoned, equals its unpoisoned run;
(c) `exact_forests` packs the forests in phase order, each forest's tiles
contiguous, with the head-value offsets `_exact_heads` reads, and the
order does not change a game;
(d) on the reference-shape heads the plays read well under every forest's
walks, so a rule that reads everything fails.
Heads: `fixtures.heads(seed, "small")` on the focus-roster fixture teams."""
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
from fast_monte_carlo_tpu_torch.ops import game as tg
from fast_monte_carlo_tpu_torch.ops import pack as tpack
from fast_monte_carlo_tpu_torch.probes import exact_walks
from fast_monte_carlo_tpu_torch.stats import TS

from test_torch_support import FOCUS_SEED, jax_heads, jax_teams, port_pack, write_focus
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

HEADS_SEED = 11
POISON_SEED = 99
N = 96          # games a poison case plays
STEPS = 48      # plays each game is given (one draw table)
FIELDS = tg.GameState._fields
# each head's channels in `_exact_heads`' tuple (p_c, pass, rush, sack,
# stage 2's pair, p_fumble, the play head's P(pass))
CHANNEL = {"stage1": 0, "pq": 1, "rq": 2, "sq": 3, "stage2": 4, "fumble": 5, "play": 6}


def _cfg(play: bool, fumble: bool, force=None) -> SimConfig:
    cfg = SimConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_play_model=play,
                                                enable_fumbles=fumble))
    return cfg.replace(fourth=dataclasses.replace(cfg.fourth, force=force))


@pytest.fixture(scope="module")
def heads():
    return fixtures.heads(HEADS_SEED, "small")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _start(state: str, cfg, n: int, k: int, players: bool, stats: bool) -> tg.GameState:
    """n games from `state`, each game's clock, field position and score
    varied where the state is a situation."""
    i = torch.arange(n, dtype=torch.int32)
    fo = i % 2
    coll = dict(collect_players=players, collect_stats=stats)
    if state == "kickoff":
        return tg.initial_state(n, fo, cfg, "cpu", k=k, **coll)
    sit = {
        "midgame": tg.Situation(fo, 1200 + i * 11 % 1500, 1 + i % 3, 10.0 - i % 7,
                                25.0 + i % 50, 14 + i % 5, 10 + i % 9),
        "fourth_short": tg.Situation(fo, 600 + i * 17 % 2400, 4, 1.0 + i % 2,
                                     5.0 + i * 3 % 80, 10 + i % 4, 13),
        "red_zone": tg.Situation(fo, 900 + i * 13 % 2000, 1 + i % 4, 3.0 + i % 8,
                                 2.0 + i % 19, 7 + i % 7, 10),
        "end_of_half": tg.Situation(fo, 1801 + i % 150, 1 + i % 4, 10.0, 20.0 + i % 60,
                                    17, 14 + i % 7),
    }[state]
    return tg.state_from_situation(n, sit, cfg, "cpu", k=k, **coll)


def _poison(heads_tuple, read: dict, gen: np.random.Generator, count: list):
    """The heads `read` marks unread replaced, row by row, by finite values
    of another seed (`count[0]` adds the rows replaced)."""
    out = list(heads_tuple)
    for head, rows in read.items():
        i = CHANNEL[head]
        unread = ~rows
        count[0] += int(unread.sum())

        def bad(t):
            noise = torch.from_numpy(gen.uniform(-40.0, 40.0, t.shape).astype(np.float32))
            mask = unread.view(-1, *([1] * (t.dim() - 1)))
            return torch.where(mask, noise, t)

        out[i] = tuple(bad(t) for t in out[i]) if head == "stage2" else bad(out[i])
    return tuple(out)


def _eager(pack, cfg, hp, s, u, z, players, stats, args=None, count=None):
    """The port's eager exact step over the draw table, every head as
    `make_exact_heads_eval` gives it or, given `args`, its unread heads
    (`exact_heads_read` of the play's state, draws and heads) poisoned; the
    loop of `simulate_games_eager` (to the last game's end)."""
    he = tg.make_exact_heads_eval(cfg)
    gen = np.random.default_rng(POISON_SEED)
    force = tg.FORCE_CODES[cfg.fourth.force]
    cur = {}

    def poisoned(state, obs, pk):
        ho = he(state, obs, pk)
        h = (ho.p_complete, ho.pass_ms, ho.rush_ms, ho.sack_ms,
             (ho.s2_cum[:, 0], ho.s2_cum[:, 1]), ho.p_fumble, ho.p_pass_ml)
        read = tg.exact_heads_read(args, obs.down, obs.dist, obs.ytg, obs.sec, obs.sd, cur["u"],
                                   h, force)
        h = _poison(h, read, gen, count)
        return tg.HeadOut(h[0], torch.stack(h[4], dim=1), h[1], h[2], h[3], h[5], h[6])

    poisoned.needs_x = True
    for j in range(u.shape[0]):
        if j and not bool((s.sec > 0).any()):
            break
        cur["u"] = u[j]
        s = tg.play_step(s, (u[j], z[j]), pack, cfg, poisoned if args is not None else he, hp,
                         players, stats)
    if stats:      # the final score in `points`, as the game loops write it
        s.stats[:, :, TS["points"]] = s.score.to(torch.float32)
    return s


def _copy(s: tg.GameState) -> tg.GameState:
    return tg.GameState(*(f.clone() for f in s))


# case: (start, play head, fumble head, stage 2, collect_players, collect_stats,
# fourth.force on every play)
POISON_CASES = {
    "kickoff_all_heads_both_collectors": ("kickoff", True, True, True, True, True, None),
    "midgame_no_play_or_fumble_head": ("midgame", False, False, True, False, False, None),
    "fourth_and_short_all_heads_box_score": ("fourth_short", True, True, True, False, True, None),
    "red_zone_no_stage2_player_stats": ("red_zone", True, True, False, True, False, None),
    "end_of_half_play_head_no_fumble_both": ("end_of_half", True, False, True, True, True, None),
    "fourth_and_short_go_every_play": ("fourth_short", False, False, True, True, True, "go"),
    "red_zone_all_heads_score_only": ("red_zone", True, True, True, False, False, None),
    "end_of_half_punt_every_play": ("end_of_half", True, True, True, True, False, "punt"),
    "midgame_no_stage2_fg_every_play": ("midgame", False, True, False, False, True, "fg"),
    "kickoff_fumble_head_only": ("kickoff", False, True, True, False, False, None),
}


@pytest.mark.parametrize("case", list(POISON_CASES))
def test_unread_heads_poisoned_play_the_same_games(case, heads, monkeypatch):
    """(a) Every head `exact_heads_read` marks unread, replaced by finite
    values of another seed in `nano_game_plain` (its `_exact_heads`) and in
    the port's eager exact step, leaves every game, its box score and player
    stats bit for bit as the unpoisoned eager loop plays them; the walks the
    plain version counts are the rows the twin marks, forest by forest."""
    start, play, fumble, stage2, players, stats, force = POISON_CASES[case]
    cfg = _cfg(play, fumble, force)
    pack, hp = tpack.build_packs(*fixtures.focus_teams(FOCUS_SEED), heads, cfg, "cpu",
                                 fixtures.COACH_MAP)
    if not stage2:
        hp = dataclasses.replace(hp, stage2=None)
    args = tg.pack_nano_game(pack, cfg, hp)
    assert {"play", "fumble", "stage2"} & set(args.exact.vals) == {
        head for head, on in (("play", play), ("fumble", fumble), ("stage2", stage2)) if on}
    s0 = _start(start, cfg, N, pack.k, players, stats)
    u, z = (torch.from_numpy(a) for a in fixtures.play_draws(np.random.default_rng(21),
                                                             (STEPS, N)))
    want = _eager(pack, cfg, hp, _copy(s0), u, z, players, stats)

    count = [0]
    eager = _eager(pack, cfg, hp, _copy(s0), u, z, players, stats, args, count)
    real = tg._exact_heads
    gen = np.random.default_rng(POISON_SEED)
    plain_count = [0]

    def poisoned(a, dirx, sd, down0, dist0, ytg0, sec0, uu):
        h = real(a, dirx, sd, down0, dist0, ytg0, sec0, uu)
        read = tg.exact_heads_read(a, down0, dist0, ytg0, sec0, sd, uu, h,
                                   a.layout.force_every)
        return _poison(h, read, gen, plain_count)

    monkeypatch.setattr(tg, "_exact_heads", poisoned)
    walks = torch.zeros(args.exact.forests.shape[0], dtype=torch.int64)
    plain = tg.nano_game_plain(args, _copy(s0), 0, draws=(u, z), walks=walks,
                               collect_players=players, collect_stats=stats)
    for f in FIELDS:
        assert torch.equal(_bits(getattr(eager, f)), _bits(getattr(want, f))), ("eager", f)
        assert torch.equal(_bits(getattr(plain, f)), _bits(getattr(want, f))), ("plain", f)
    assert count[0] > 0 and plain_count[0] > 0
    trees = torch.tensor([tf.n_trees for _, tf, *_ in args.exact.heads])
    assert bool((walks % trees == 0).all()) and 0 < int(walks.sum())


def test_jax_play_step_reads_only_what_the_rule_marks(heads, tmp_path):
    """(b) 128 games fed one draw table through the JAX package's exact
    `play_step` (all heads: stage 2, the fumble and play heads), a play at
    a time: each play's heads as the JAX heads eval gives them, the rows of
    each head the port's `exact_heads_read` leaves unread (of the JAX
    state, draws and heads) poisoned with finite values of another seed,
    then the play.  The integer state equals the unpoisoned scan's."""
    b = 128
    cfg = _cfg(True, True)
    jcfg = JaxSimConfig()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, enable_fumbles=True,
                                                  use_play_model=True))
    u, z = fixtures.play_draws(np.random.default_rng(14), (cfg.engine.max_plays, b))
    jpack, jhp = jax_build_packs(*jax_teams(8, write_focus(tmp_path / "focus.csv")),
                                 jax_heads(heads), jcfg, fixtures.COACH_MAP)
    args = tg.pack_nano_game(port_pack(jpack), cfg, tpack.pack_heads(heads, "cpu"))
    jhe = jg.make_exact_heads_eval(jcfg)
    s0 = jg.initial_state(b, jnp.asarray(np.arange(b) % 2, jnp.int32), jcfg, 8,
                          collect_players=False, collect_stats=False)

    def given_heads(state, obs, pk):
        return state

    given_heads.needs_x = True

    @jax.jit
    def heads_of(s, uu):
        # play_step's observation of the play (its state features and slots)
        off, dirx = s.off, s.gid * 2 + s.off
        sd = (s.score[:, 0] - s.score[:, 1]) * (1 - 2 * off)
        x = jg._state_features(jpack, jcfg, dirx, s.down, s.dist, s.ytg, s.sec, sd)
        obs = jg.StepObs(x=x, sd=sd.astype(jnp.float32), dirx=dirx, off=off, down=s.down,
                         dist=s.dist, ytg=s.ytg, sec=s.sec,
                         qb=jg._sample_slot(jpack.qb_cum, dirx, uu[:, jg.U_QB]),
                         wr=jg._sample_slot(jpack.wr_cum, dirx, uu[:, jg.U_WR]),
                         rb=jg._sample_slot(jpack.rb_cum, dirx, uu[:, jg.U_RB]))
        return jhe(jhp, obs, jpack)

    @jax.jit
    def step(s, ho, uu, zz):
        return jg.play_step(s, jax.random.PRNGKey(0), jpack, jcfg, given_heads, ho, False,
                            False, draws=(uu, zz))

    gen = np.random.default_rng(POISON_SEED)
    count = [0]

    def run(poison: bool):
        s = s0
        for j in range(u.shape[0]):
            if not bool(np.asarray(s.sec > 0).any()):
                break
            ho = heads_of(s, jnp.asarray(u[j]))
            if poison:
                t = {k: torch.from_numpy(np.array(v)) for k, v in s._asdict().items()
                     if k in ("off", "down", "dist", "ytg", "sec", "score")}
                sd = (t["score"][:, 0] - t["score"][:, 1]) * (1 - 2 * t["off"])
                h = tuple(torch.from_numpy(np.array(x)) for x in ho)
                h = (h[0], h[2], h[3], h[4], (h[1][:, 0], h[1][:, 1]), h[5], h[6])
                read = tg.exact_heads_read(args, t["down"], t["dist"], t["ytg"], t["sec"], sd,
                                           torch.from_numpy(u[j]), h)
                h = _poison(h, read, gen, count)
                ho = jg.HeadOut(*(jnp.asarray(x.numpy()) for x in (
                    h[0], torch.stack(h[4], dim=1), h[1], h[2], h[3], h[5], h[6])))
            s = step(s, ho, jnp.asarray(u[j]), jnp.asarray(z[j]))
        return s

    want, got = run(False), run(True)
    assert count[0] > 0
    for f in ("off", "sec", "down", "period", "in_rz", "going", "score"):
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
    assert not np.asarray(want.sec).any() and 10 < np.asarray(want.score).mean() < 50


# heads: (fixture shape, config with the play and fumble heads)
ORDER_HEADS = ("small", "reference", "tiled")


@pytest.mark.parametrize("shape", ORDER_HEADS)
def test_exact_forests_in_phase_order(shape, heads):
    """(c) The forests K1 walks, packed in phase order (the play head;
    stage 1, stage 2, the rush trio, the fumble head; the pass and sack
    trios): each forest's tiles contiguous and its own, each descriptor
    naming its row list and trees, the phases' first forests in
    LayoutConsts, the play head's pass and run classes as bit masks, the
    head values at the offsets `_exact_heads` reads (`vals`, a trio's
    forests in order); and a reordering of the forests
    (their tiles and values unmoved) leaves every head value, so every
    game, as it is."""
    cfg = _cfg(True, True)
    h = heads if shape == "small" else fixtures.heads(HEADS_SEED, shape)
    pack, hp = tpack.build_packs(*fixtures.focus_teams(FOCUS_SEED), h, cfg, "cpu",
                                 fixtures.COACH_MAP)
    args = tg.pack_nano_game(pack, cfg, hp)
    ex = args.exact
    names = [head for head, *_ in ex.heads]
    phases = [tg.EXACT_LISTS[head] // 2 for head in names]
    assert phases == sorted(phases) and names[0] == "play" and names[-1] == "sq"
    assert ex.phase_forest == tuple(args.layout.phase_forest) == (0, 1, 1 + names.index("pq") - 1,
                                                                  len(names))
    d, t = ex.forests.tolist(), ex.tiles.tolist()
    first_value, seen = 0, {}
    for fi, (head, tf, *_) in enumerate(ex.heads):
        first, n = d[fi][:2]
        assert [row[4] for row in t[first:first + n]] == [fi] * n
        assert first == sum(d[g][1] for g in range(fi))
        masks = [1 << hp.play_pass_idx, 1 << hp.play_run_idx if hp.play_run_idx >= 0 else 0]
        assert d[fi][20:24] == [tg.EXACT_LISTS[head], tf.n_trees] + (
            masks if head == "play" else [0, 0])
        i = seen[head] = seen.get(head, -1) + 1
        assert d[fi][7] == first_value == ex.vals[head] + i * (tf.n_classes if head == "stage2"
                                                               else 1)
        first_value += tf.n_classes if head == "stage2" else 1
        assert t[first][2] == sum(g.n_trees for _, g, *_ in ex.heads[:fi])
    assert sum(n for _, n, *_ in d) == len(t)
    for head in ("stage1", "stage2", "pq", "rq", "sq", "fumble", "play"):
        assert getattr(args.layout, f"v_{head}") == ex.vals[head]

    rng = np.random.default_rng(8)
    st = fixtures.play_states(rng, 256)
    s = {k: torch.from_numpy(v) for k, v in st.items()}
    u = torch.from_numpy(fixtures.play_draws(rng, (256,))[0])
    sd = (s["score"][:, 0] - s["score"][:, 1]) * (1 - 2 * s["off"])
    dirx = s["gid"] * 2 + s["off"]
    call = (dirx, sd, s["down"], s["dist"], s["ytg"], s["sec"], u)
    want = tg._exact_heads(args, *call)
    order = [i for i, head in enumerate(names) if head in ("pq", "rq", "sq")] + [
        i for i, head in enumerate(names) if head not in ("pq", "rq", "sq")][::-1]
    moved = args._replace(exact=dataclasses.replace(ex, heads=tuple(ex.heads[i] for i in order)))
    got = tg._exact_heads(moved, *call)
    for a, b in zip(got, want):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(_bits(x), _bits(y))


def test_plays_read_well_under_every_forest(heads):
    """(d) On the reference-shape heads (stage 1 of 188 trees 6 deep, nine
    quantile forests of 400): 512 play states read about a quarter of every
    forest's (row, tree) walks by the rule, and the probe's count of a whole
    launch of games (`probes.exact_walks`, 16 games) a share as far under
    one; each forest is read by some rows and not all."""
    cfg = SimConfig()
    pack, hp = tpack.build_packs(*fixtures.teams(), fixtures.heads(0, "reference"), cfg, "cpu")
    args = tg.pack_nano_game(pack, cfg, hp)
    rng = np.random.default_rng(4)
    n = 512
    s = {k: torch.from_numpy(v) for k, v in fixtures.play_states(rng, n).items()}
    u = torch.from_numpy(fixtures.play_draws(rng, (n,))[0])
    sd = (s["score"][:, 0] - s["score"][:, 1]) * (1 - 2 * s["off"])
    h = tg._exact_heads(args, s["gid"] * 2 + s["off"], sd, s["down"], s["dist"], s["ytg"],
                        s["sec"], u)
    read = tg.exact_heads_read(args, s["down"], s["dist"], s["ytg"], s["sec"], sd, u, h)
    walks = tg.exact_walk_counts(args, read)
    trees = [tf.n_trees for _, tf, *_ in args.exact.heads]
    share = float(walks.sum()) / (int((s["sec"] > 0).sum()) * sum(trees))
    assert 0.1 < share < 0.5, share
    for head, rows in read.items():
        assert 0 < int(rows.sum()) < n, head
    assert bool((read["pq"] <= read["stage1"]).all()) and not bool((read["pq"] & read["rq"]).any())
    probe = exact_walks.walk_share(16, "cpu")
    assert 0.1 < probe["share"] < 0.5 and probe["walks"] == [
        int(w) for w in probe["walks"]] and probe["plays"] > 16 * 100
