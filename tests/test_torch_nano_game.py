"""K1, the game kernel (`ops/game.nano_game`), and K2, the moment kernel
(`parallel/aggregate.exact_moments_cuda`), on the CPU.

The kernels run only on the card (`chip_smoke.py` phase 21 holds them to
their plain versions there).  Here K1's plain version, `nano_game_plain`,
which reads exactly the packed inputs the launcher passes, is held bit for
bit to the eager game loop (`simulate_games_eager`) on every GameState
field, and within the 98%-of-games standard of tests/test_torch_game.py to
the JAX package's `play_step` scanned over one draw table; the predicate
that picks K1 is checked over a table of cases; the packed constants are
checked against the kernel's struct in the source."""
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
from fast_monte_carlo_tpu_torch.models.tables import marginalize_sd, nano_from_fused, nano_profile
from fast_monte_carlo_tpu_torch.ops import game as tg
from fast_monte_carlo_tpu_torch.ops import table_lookup as ttl
from fast_monte_carlo_tpu_torch.ops.pack import pack_matchups
from fast_monte_carlo_tpu_torch.ops.rng import fold_in, root_key, step_draws
from fast_monte_carlo_tpu_torch.parallel import aggregate as tagg
from fast_monte_carlo_tpu_torch.utils.cuda_build import CSRC

from test_torch_support import (TABLE_SEED, heads_pair, jax_pack, port_pack,
                                table_cache_off)  # noqa: F401  (autouse fixture)

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


def test_nano_game_plain_matches_jax_on_one_draw_table():
    """512 games fed one (max_plays, B, 17) draw table: `nano_game_plain`
    on the fixture nano table against the JAX package's `play_step`
    scanned over the same table, the whole-game standard of
    tests/test_torch_game.py (>= 98% of final scores equal; the rest sit
    within an ulp of a threshold, where XLA's FMAs round otherwise)."""
    b = 512
    cfg, jcfg = SimConfig(), JaxSimConfig()
    steps = cfg.engine.max_plays
    rng = np.random.default_rng(12)
    u, z = fixtures.play_draws(rng, (steps, b))
    jpack = jax_pack()
    pack = port_pack(jpack)
    jhe, jhs, _, th = heads_pair("table")
    fo = np.arange(b) % 2

    def run_jax(h, uu, zz):
        s0 = jg.initial_state(b, jnp.asarray(fo, jnp.int32), jcfg, 8,
                              collect_players=False, collect_stats=False)

        def body(s, xs):
            return jg.play_step(s, jax.random.PRNGKey(0), jpack, jcfg, jhe, h,
                                False, False, draws=xs), None

        return jax.lax.scan(body, s0, (uu, zz))[0]

    want = np.asarray(jax.jit(run_jax)(jhs, jnp.asarray(u), jnp.asarray(z)).score)
    s0 = tg.initial_state(b, torch.from_numpy(fo), cfg, "cpu", collect_players=False,
                          collect_stats=False)
    got = tg.nano_game_plain(tg.pack_nano_game(pack, cfg, th), s0, 0,
                             draws=(torch.from_numpy(u), torch.from_numpy(z)))
    assert (got.sec == 0).all()
    same = (got.score.numpy() == want).all(axis=1)
    assert same.mean() >= 0.98, f"{(~same).sum()} of {b} games differ"
    assert 10 < want.mean() < 50


def _nano_th():
    return ttl.pack_tables(*fixtures.nano_tables(TABLE_SEED), device="cpu")


# case: (heads, heads state change, config change, collect_players,
# collect_stats, K1 covers it)
_PLAY = SimConfig().replace(model=dataclasses.replace(
    SimConfig().model, use_play_model=True))
COVER_CASES = {
    "nano_score_only": ("table", {}, None, False, False, True),
    "play_table_unused": ("table", {"play": "nano"}, None, False, False, True),
    "play_table_used": ("table", {"play": "nano"}, _PLAY, False, False, False),
    "play_model_without_table": ("table", {}, _PLAY, False, False, True),
    "players": ("table", {}, None, True, False, False),
    "box_score": ("table", {}, None, False, True, False),
    "forced_go": ("table", {}, "go", False, False, False),
    "fused_layout": ("table", {"nano": None, "fused": "nano"}, None, False, False, False),
    "analytic": ("analytic", {}, None, False, False, False),
    "exact": ("exact", {}, None, False, False, False),
}


@pytest.mark.parametrize("case", list(COVER_CASES))
def test_nano_game_covers_exactly_the_score_only_nano_launches(case):
    """K1 takes table heads on a nano table, with no play-policy lookup,
    both collectors off and no forced 4th-down choice; everything else
    stays on the eager loop."""
    heads, change, cfg_change, players, stats, covered = COVER_CASES[case]
    cfg = SimConfig()
    if cfg_change == "go":
        cfg = cfg.replace(fourth=dataclasses.replace(cfg.fourth, force="go"))
    elif cfg_change is not None:
        cfg = cfg_change
    th = _nano_th()
    th = dataclasses.replace(th, **{k: (th.nano if v == "nano" else v)
                                    for k, v in change.items()})
    he = {"table": ttl.make_table_heads_eval, "analytic": tg.make_analytic_heads_eval,
          "exact": tg.make_exact_heads_eval}[heads](cfg)
    hs = th if heads == "table" else None
    assert tg.nano_game_covers(cfg, he, hs, players, stats) is covered


def _struct_fields(src: str, name: str):
    """(field, array length or 0) of `struct name` in a CUDA source, in
    order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        names = decl.split(" ", 1)[1]
        for v in names.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\w+)\])?\s*", v)
            out.append((m.group(1), m.group(2) or 0))
    return out


def test_packed_constants_follow_the_kernel_struct():
    """`NanoConsts` and `_Segs` name the kernel's fields in its order, with
    its array lengths (the launcher checks the total size on the card);
    the defaults pack as the eager loop runs: 360 plays, the padded edges,
    the nano profile's segments."""
    src = (CSRC / "nano_game.cu").read_text()
    consts = {"kSlots": tg._SLOTS, "kSegs": tg._SEGS, "kGridCells": tg._GRID_CELLS}

    def ctypes_fields(cls):
        return [(n, getattr(t, "_length_", 0)) for n, t in cls._fields_]

    for cls, name in ((tg.NanoConsts, "NanoConsts"), (tg._Segs, "Segs")):
        want = [(n, (consts[k] if k in consts else int(k)) if k else 0)
                for n, k in _struct_fields(src, name)]
        assert ctypes_fields(cls) == want, name
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
