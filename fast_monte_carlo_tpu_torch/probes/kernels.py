"""The CUDA kernels alone, timed by held CUDA events.

    python -m fast_monte_carlo_tpu_torch.probes.kernels [--csrc DIR]
        [--forests-only | --games-only | --gathers-only] [--sass DIR]

builds every source of `csrc/` (or of DIR, a variant of this commit's
`csrc/` whose K1 and K2 launchers take the package's parameters, so that
two versions are timed in one call, one process each; an earlier commit is
timed by its own copy of this probe, from its `git archive`),
prints the registers and spill bytes of each kernel it times (`nvcc
-Xptxas -v`;
`--sass DIR` also writes each built source's `cuobjdump -sass` there and
prints the gather kernels' instruction counts) and
the device time per call of each kernel at the shapes `chip_smoke.py`
times (row_gather at every gather probe's shape, beside `index_select` and
its bytes bound: `gather_yardsticks`), of a step of
the probe loops that launch fused_step_tab, row_gather_sum and row_gather,
in their own launch order (`path_times`), and of a near-empty launch
(`torch.cuda._sleep(1)`): the gap between back-to-back kernels that every
held time includes.  `--gathers-only` times the gather kernels alone.
K5 (`forest_times`) is timed at the exact-mode play's shapes: each forest
of `fixtures.heads(0, "reference")` on 65,536 rows of play states, and
their sum over the 11 forests a play evaluates at the default config; a
DIR whose forest_eval.cu has the first K5's launcher (one f32 node table)
gets its inputs packed for that launcher.  `--forests-only`
times K5 alone.  K1 and K2 (`game_times`) are timed at phase 21's shapes:
K1 a 65,536-game launch and a 60-matchup slate launch of 1,966,080 games,
K2 at (1, 65,536) and (60, 32,768), each beside its bound; K1's lane share
(plays over 32 lanes x the loop trips its warps ran) is printed for the
persistent layout (its own counter) and for one game a thread, the first K1's layout
(each 32 consecutive games' longest, from the per-game plays).  K1 is
also timed with each combination of the collectors at 65,536 games of the
focus-roster fixture (`COLLECTORS`), and on each other layout
(`layout_times`: fused tables, the play-policy table, a focus roster's
per-head tables score-only and with both collectors, a forced first play)
in turns with the nano score-only launch (nano, layout, layout, nano), and
on fused tables over a 60-matchup slate launch (`fused_slate_time`).
Copied into an earlier commit's archive, it times that commit's kernels
and wrappers the same way (`kind_of`).
`--games-only` times K1 and K2 alone.  `--sass-against FILE` compares the
nano instantiations' SASS with FILE's (another commit's `--sass` output of
nano_game.cu), instruction for instruction; `--sass-against DIR`, another
commit's whole `--sass` directory, compares every kernel there (K5's, every
K1 instantiation) with the kernel of the same mangled name here.  The last line is one JSON object of the
times.
philox_draws is timed at row offset `DRAW_ROW0` (the rows a second rank
plays); a DIR whose philox_draws.cu predates the row offset (its launcher
takes no row0) has its draws left out.

`held_ms` is the timer, and `kernel_times` the kernel times, that
`chip_smoke.py` reports: CUDA events around back-to-back calls that the
host enqueued while a spin kernel held the stream, so that a call of a few
microseconds is not timed by the host's launch rate.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils import cuda_build
from . import gather

GAME_SOURCES = ("nano_game", "score_moments")
GATHER_SOURCES = ("row_gather",)
SOURCES = ("philox_draws", "fused_step") + GATHER_SOURCES + ("forest_eval",) + GAME_SOURCES
# what kernel_times times, with the calls of each held run: row_gather at
# every gather probe's shape
RUNS = {"philox_draws ch=24": 50, "philox_draws ch=1": 200, "fused_step ch=24": 50,
        "fused_step ch=1": 200, "fused_step_tab": 200, "row_gather_sum B3": 200,
        f"row_gather_sum B6 B={gather.B6_BS[-1]}": 200,
        **{f"row_gather {what}": 200 for what in gather.PROBE_SHAPES}}
# philox_draws' first row in kernel_times: rank 1's rows of a two-rank
# launch of 131,072 games
DRAW_ROW0 = 65_536
# what path_times times: steps of each probe loop in one held run, about
# 530, 260 and 200 launches, within the card's launch queue; B5's steps at
# each R are its probe's own loop
PATH_STEPS = {"hybrid-tab step": 16, "B3 loop step": 64,
              **{f"B5 loop step R={rows}": gather.B5_ITERS for rows in gather.B5_ROWS}}
# K5's inputs: fixtures.heads(HEADS_SEED, "reference") on the focus-roster
# teams of FOCUS_SEED, K5_B rows a launch, K5_REPS calls a held run
HEADS_SEED, FOCUS_SEED, K5_B, K5_REPS = 0, 3, 65_536, 20
# calls of each held run of K1 (a 65,536-game launch, a slate launch) and K2
GAME_REPS = {"nano_game": 10, "nano_game slate": 3, "score_moments": 20,
             "score_moments G=60": 20}
# games the plain version plays on the card to check K1's launch
GAME_CHECK = 4_096
# K1's exact instantiation (`exact_time`): calls of each held run (a call
# is about 0.05-0.13 s), its key (phase 12's), and the games its plain
# version plays on the card to check its launch (the plain version walks
# every forest in torch: seconds a game's worth of plays)
EXACT_REPS, EXACT_KEY, EXACT_CHECK = 3, 41, 256


@functools.lru_cache(maxsize=None)
def cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` per ms, measured on the card."""
    torch.cuda._sleep(1000)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    torch.cuda._sleep(20_000_000)
    t1.record()
    torch.cuda.synchronize()
    return 20_000_000 / t0.elapsed_time(t1)


# held measurements of a kernel before kernel_times gives up
HELD_TRIES = 3


def held_ms(fn, reps: int):
    """(ms per call, held): CUDA events around `reps` back-to-back calls
    that the host enqueues while a spin kernel holds the stream, so that
    the events time the calls' device work and not the host's time between
    launches, which bounds a call of a few microseconds.  `held` is False
    where the host was still enqueuing when the hold ended (a plain version
    of thousands of kernels fills the launch queue); the time then includes
    the host's."""
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    hold = 2 * (time.perf_counter() - h0) * 1e3 + 1.0
    torch.cuda.synchronize()
    for _ in range(2):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold * cycles_per_ms()))
        t0.record()
        h0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue = (time.perf_counter() - h0) * 1e3
        t1.record()
        held = not t0.query()
        torch.cuda.synchronize()
        if held or enqueue >= hold:          # a longer hold would not help
            break
        hold *= 4
    return t0.elapsed_time(t1) / reps, held


@functools.lru_cache(maxsize=None)
def launch_gap_ms() -> float:
    """Held time of a near-empty kernel (`torch.cuda._sleep(1)`), measured
    once: the card's gap between back-to-back launches, which every held
    time includes."""
    return held_ms(lambda: torch.cuda._sleep(1), 200)[0]


def kernel_times(dev: torch.device, names: Sequence[str] = tuple(RUNS)) -> Dict[str, float]:
    """Held ms per call of each kernel of `names` (keys of RUNS):
    philox_draws at (24, 65,536) into a held buffer and at (1, 65,536),
    from row DRAW_ROW0;
    fused_step at B = 131,072, ch = 24 and 1, from kick-off; fused_step_tab
    at B = 131,072; row_gather_sum at B3's shape and at B6's 8,192 rows of
    128; row_gather at every shape of `gather.probe_shapes`.  Each kernel
    runs back to back after itself, a launch order no probe has
    (`path_times` times theirs).  Raises where the hold did not
    cover the enqueue in any of HELD_TRIES measurements (a kernel's enqueue
    takes microseconds, so a miss is the host stalling, not the kernel)."""
    from ..ops import rng
    from . import step_arith as sa

    key = rng.root_key(2)
    calls = {}
    if any(n.startswith("philox") for n in names):
        buf = (torch.empty((24, 65536, rng.N_UNIFORMS), device=dev),
               torch.empty((24, 65536, rng.N_NORMALS), device=dev))
        calls["philox_draws ch=24"] = lambda: rng.chunk_draws(key, 0, 24, 65536, dev, out=buf,
                                                              row0=DRAW_ROW0)
        calls["philox_draws ch=1"] = lambda: rng.step_draws(key, 0, 65536, dev, row0=DRAW_ROW0)
    if any(n.startswith("fused") for n in names):
        s0 = sa.init_state(sa.B_DEFAULT, dev)
        heads = sa.heads_of(s0, sa.make_table(dev))
        calls["fused_step ch=24"] = lambda: sa.fused_step(s0, key, 0, sa.CH)
        calls["fused_step ch=1"] = lambda: sa.fused_step(s0, key, 0, 1)
        calls["fused_step_tab"] = lambda: sa.fused_step_tab(s0, heads, key, 0)
    if any(n.startswith("row_gather") for n in names):
        for what, table, idx in gather.probe_shapes(dev):
            for fn in (gather.row_gather, gather.row_gather_sum):
                if f"{fn.__name__} {what}" in RUNS:
                    calls[f"{fn.__name__} {what}"] = functools.partial(fn, table, idx)
    out = {}
    for name in names:
        for _ in range(HELD_TRIES):
            ms, held = held_ms(calls[name], RUNS[name])
            if held:
                break
        else:
            raise RuntimeError(f"{name}: the hold did not cover the enqueue")
        out[name] = ms
    return out


def path_times(dev: torch.device, names: Sequence[str] = tuple(PATH_STEPS)) -> Dict[str, float]:
    """Held device ms per step of each probe loop of `names` (keys of
    PATH_STEPS) that launches fused_step_tab, row_gather_sum or row_gather,
    in the order it launches them: a hybrid-tab step at B = 131,072
    (`heads_of`'s torch kernels, then fused_step_tab on the previous step's
    state), a step of B3's loop (the index shift in torch, row_gather_sum,
    the accumulate) and a step of B5's loop at each R (`gather.b5_loop`:
    the shift and `%` in torch, row_gather, the accumulate).  There each
    kernel follows and precedes torch kernels.  Each held run starts anew
    from the same inputs.  Raises where the hold did not cover the
    enqueue."""
    from ..ops import rng
    from . import step_arith as sa

    key, values = rng.root_key(8), sa.make_table(dev)
    s0 = sa.init_state(sa.B_DEFAULT, dev)
    tab, idx = gather.b3_inputs(dev)
    b5 = {rows: gather.b5_inputs(rows, dev) for rows in gather.B5_ROWS}

    def hybrid():
        s = s0
        for j in range(PATH_STEPS["hybrid-tab step"]):
            s = sa.fused_step_tab(s, sa.heads_of(s, values), key, j)
        return s

    runs = {"hybrid-tab step": hybrid,
            "B3 loop step": lambda: gather.b3_loop(gather.row_gather_sum, tab, idx,
                                                   steps=PATH_STEPS["B3 loop step"]),
            **{f"B5 loop step R={rows}": functools.partial(
                gather.b5_loop, gather.row_gather, *b5[rows],
                steps=PATH_STEPS[f"B5 loop step R={rows}"]) for rows in gather.B5_ROWS}}
    out = {}
    for name in names:
        ms, held = held_ms(runs[name], 1)
        if not held:
            raise RuntimeError(f"{name}: the hold did not cover the enqueue")
        out[name] = ms / PATH_STEPS[name]
    return out


def gather_yardsticks(dev: torch.device) -> Dict[str, dict]:
    """At every gather probe's shape: `index_select`'s held ms (one PyTorch
    call computing row_gather's function on in-range indices) and
    row_gather's bytes bound (`gather.row_gather_bytes` at the HBM rate,
    `chip_smoke.bound`)."""
    import chip_smoke as cs    # the smoke's rates (run from the repo root)

    out = {}
    for what, table, idx in gather.probe_shapes(dev):
        out[what] = {"index_select": _held(lambda: torch.index_select(table, 0, idx),
                                           RUNS[f"row_gather {what}"], f"index_select {what}"),
                     "bound_ms": cs.bound(gather.row_gather_bytes(table, idx), {})["bound_ms"]}
    return out


def k5_forests(dev: torch.device):
    """The reference-shape heads on `dev`: (the ModelHeads, FlatForest by
    name, TorchForest by name, the names a play evaluates at the default
    config (no fumbles, no play policy), the matchup pack of the
    focus-roster teams)."""
    from .. import fixtures
    from ..config import SimConfig
    from ..ops.pack import build_packs

    heads = fixtures.heads(HEADS_SEED, "reference")
    pack, hp = build_packs(*fixtures.focus_teams(FOCUS_SEED), heads, SimConfig(), dev,
                           fixtures.COACH_MAP)
    host = {"stage1": heads.stage1, "stage2": heads.stage2, "fumble": heads.fumble,
            "play": heads.play}
    packed = {"stage1": hp.stage1, "stage2": hp.stage2, "fumble": hp.fumble, "play": hp.play}
    for kind, trio, ptrio in (("pq", heads.pass_quants, hp.pq), ("rq", heads.rush_quants, hp.rq),
                              ("sq", heads.sack_quants, hp.sq)):
        for i in range(3):
            host[f"{kind}{i}"], packed[f"{kind}{i}"] = trio[i], ptrio[i]
    play = [k for k in packed if k not in ("fumble", "play")]
    return heads, host, packed, play, pack


def k5_rows(pack, rng: np.random.Generator, b: int, dev: torch.device):
    """(x (b, 17) f32 ST1 feature rows of `fixtures.play_states`, as exact
    mode builds them, and (b,) int32 ids from -1 over the first few
    categories for each group)."""
    from .. import fixtures
    from ..config import SimConfig
    from ..ops import game

    d = fixtures.play_states(rng, b)
    t = {k: torch.tensor(v, device=dev) for k, v in d.items()}
    sd = (t["score"][:, 0] - t["score"][:, 1]) * (1 - 2 * t["off"])
    x = game._state_features(pack, SimConfig(), t["gid"] * 2 + t["off"], t["down"], t["dist"],
                             t["ytg"], t["sec"], sd)
    return x, {g: torch.tensor(rng.integers(-1, 8, b).astype(np.int32), device=dev)
               for g in ("passer_name", "target_name", "rusher_name", "head_coach")}


def k5_args(tf, x: torch.Tensor, ids: dict):
    """The feature columns and ids forest tf reads: the play head its 12
    numerics."""
    xx = x if x.shape[1] == len(tf.numeric_names) else x[:, :len(tf.numeric_names)].contiguous()
    return xx, {g: ids[g] for g in tf.group_names}


def _node_table_call(lib, tf, x: torch.Tensor, cid: torch.Tensor):
    """A call of the first K5's launcher, `forest_eval_launch` (the (N, 8) f32
    node table, leaves, roots), on the current stream."""
    import ctypes

    fn = lib.forest_eval_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((x.shape[0], tf.n_classes), dtype=torch.float32, device=x.device)

    def call():
        err = fn(tf.nodes.data_ptr(), tf.leaf.data_ptr(), tf.roots.data_ptr(),
                 tf.tree_class.data_ptr(), tf.base_margin.data_ptr(), x.data_ptr(),
                 cid.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], cid.shape[1],
                 tf.n_trees, tf.n_classes, tf.max_depth, int(tf.cmp_lt),
                 int(tf.zero_as_missing), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forest_eval_launch failed: CUDA error {err}")
        return out
    return call


def forest_times(dev: torch.device, lib) -> Dict[str, float]:
    """Held ms per K5 launch on each reference-shape forest at K5_B rows
    and their sum over a play's forests ("forest_eval a play"; "forest_eval
    play" is the play head), through the forest_eval library `lib`: the
    wrapper's launcher (`forest_eval_packed_launch`) or the first K5's
    (`forest_eval_launch`).  Each
    forest's margins are first held to `eval_margin_reference`
    (rtol=1e-5, atol=1e-4); raises where they are not, or where the hold
    did not cover the enqueue."""
    from ..ops import forest_eval as fe

    *_, packed, play, pack = k5_forests(dev)
    x, ids = k5_rows(pack, np.random.default_rng(12), K5_B, dev)
    out, equal = {}, 0
    for name, tf in packed.items():
        xx, cats = k5_args(tf, x, ids)
        cid = fe.category_matrix(tf, cats, K5_B, dev)
        call = (functools.partial(fe.eval_margin_cuda, tf, xx, cid)
                if hasattr(lib, "forest_eval_packed_launch")
                else _node_table_call(lib, tf, xx, cid))
        got, want = call().clone(), fe.eval_margin_reference(tf, xx, cats)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
            raise RuntimeError(f"forest_eval {name}: off its plain version by "
                               f"{float((got - want).abs().max()):.3g}")
        equal += int(torch.equal(got, want))
        ms, held = held_ms(call, K5_REPS)
        if not held:
            raise RuntimeError(f"forest_eval {name}: the hold did not cover the enqueue")
        out[f"forest_eval {name}"] = ms
    out["forest_eval a play"] = sum(out[f"forest_eval {k}"] for k in play)
    print(f"  forest_eval bitwise equal to its plain version on {equal} of {len(packed)} forests")
    return out


def lane_share_one_a_thread(game_plays: torch.Tensor) -> float:
    """K1's lane share under one thread a game (the first K1's layout): the plays
    over 32 lanes x each warp's trips, a warp being 32 consecutive games
    and its trips its longest game's plays."""
    n = game_plays.shape[0]
    gp = torch.nn.functional.pad(game_plays.long(), (0, -n % 32)).view(-1, 32)
    return float(gp.sum()) / (32 * float(gp.max(dim=1).values.sum()))


def game_times(dev: torch.device) -> Dict[str, dict]:
    """K1 and K2 at phase 21's shapes, through the package's wrappers: held
    ms, the bound (`chip_smoke.nano_bound` on the launch's plays,
    `moment_bound`) and its share, and K1's lane shares.  K1's 65,536-game
    launch is first held to `nano_game_plain` on its first GAME_CHECK games
    (played alone at their own rows) and K2 to the torch body, bit for
    bit; raises where they differ or where the hold did not cover the
    enqueue.  K1 is also timed with each combination of the collectors
    (`_collector_times`)."""
    import chip_smoke as cs    # the smoke's shapes and bounds (run from the repo root)

    from .. import api, fixtures
    from ..config import SimConfig
    from ..matchup import build_direction
    from ..ops import game, rng
    from ..ops import table_lookup as tl
    from ..ops.pack import pack_matchup
    from ..parallel import aggregate as agg

    cfg = SimConfig()
    key = rng.root_key(61)
    a, b = fixtures.teams()
    pack = pack_matchup(build_direction(a, b, cfg), build_direction(b, a, cfg), dev)
    th = tl.pack_tables(*fixtures.nano_tables(cs.TABLE_SEED), device=dev)
    n = cs.LAUNCH_GAMES
    fo = torch.arange(n, dtype=torch.int32, device=dev) % 2
    s0 = game.initial_state(n, fo, cfg, dev, collect_players=False, collect_stats=False)
    args = game.pack_nano_game(pack, cfg, th)
    matchups, tables = fixtures.slate(cs.SLATE_GAMES, cs.SLATE_SEED)
    sr = api.SlateRunner(matchups, None, cfg, game_shard=True, nano_tables=tables, device=dev)
    per = 2 * cs.SLATE_CHUNK
    sn = cs.SLATE_GAMES * per
    t = torch.arange(sn, dtype=torch.int32, device=dev)
    s_slate = game.initial_state(sn, t % 2, cfg, dev, t // per, collect_players=False,
                                 collect_stats=False)
    slate_args = game.pack_nano_game(sr.pack, cfg, sr.heads_state)

    def k1(a_, s_, plays=None, iters=None, game_plays=None):
        return game.nano_game_cuda(a_, s_, key, plays=plays, iters=iters,
                                   game_plays=game_plays).score

    scores = k1(args, s0).view(1, n, 2)
    m = GAME_CHECK
    plain = game.nano_game_plain(args, game.initial_state(m, fo[:m], cfg, dev,
                                                          collect_players=False,
                                                          collect_stats=False), key)
    if not torch.equal(plain.score, scores[0, :m]):
        raise RuntimeError(f"nano_game: {int((plain.score != scores[0, :m]).any(1).sum())} of "
                           f"the first {m:,} games differ from nano_game_plain")
    gen = torch.Generator(device=dev).manual_seed(64)
    sc60 = torch.randint(0, 70, (60, 32_768, 2), generator=gen, device=dev, dtype=torch.int32)

    def k2(sc):
        return agg.exact_moments_cuda(sc)

    for sc in (scores, sc60):
        want = agg.exact_moments_plain(sc)
        got = k2(sc)
        got = (torch.cat([f.reshape(-1) for f in got[:5]]),
               torch.cat([f.reshape(-1) for f in got[5:]]))
        g = sc.shape[0]
        want_counts = torch.cat([want.n.reshape(-1), want.wins.reshape(-1),
                                 want.ties.reshape(-1), want.s_sum.reshape(-1),
                                 want.s_sumsq.reshape(-1)])
        want_hist = torch.cat([f.reshape(-1) for f in want[5:]]).int()
        if not (torch.equal(got[0], want_counts) and torch.equal(got[1], want_hist)):
            raise RuntimeError(f"score_moments at ({g}, {sc.shape[1]:,}): off the torch body")

    out = {}
    for name, a_, s_, games, table in (("nano_game", args, s0, n, th),
                                       ("nano_game slate", slate_args, s_slate, sn,
                                        sr.heads_state)):
        plays = torch.zeros(1, dtype=torch.int64, device=dev)
        iters = torch.zeros(1, dtype=torch.int64, device=dev)
        gp = torch.empty(games, dtype=torch.int32, device=dev)
        k1(a_, s_, plays, iters, gp)
        rec = {"lane_share": float(plays) / (32 * float(iters)),
               "lane_share_one_a_thread": lane_share_one_a_thread(gp)}
        bd = cs.nano_bound(games, int(plays), table.nano_values.numel() * 4)
        ms = _held(lambda: k1(a_, s_), GAME_REPS[name], name)
        out[name] = {"ms": ms, "plays": int(plays), "bound_ms": bd["bound_ms"],
                     "bound_class": bd["bound_class"], "share": bd["bound_ms"] / ms, **rec}
    out.update(_collector_times(dev, cs, cfg, key, th, fo))
    out.update(layout_times(dev, cs, cfg, key, pack, th, fo))
    out.update(fused_slate_time(dev, cs, cfg, key))
    for name, sc in (("score_moments", scores), ("score_moments G=60", sc60)):
        bd = cs.moment_bound(sc.shape[0], sc.shape[1])
        ms = _held(lambda: k2(sc), GAME_REPS[name], name)
        out[name] = {"ms": ms, "bound_ms": bd["bound_ms"], "bound_class": bd["bound_class"],
                     "share": bd["bound_ms"] / ms}
    return out


def exact_time(dev: torch.device, check: bool = True) -> Dict[str, dict]:
    """K1's exact instantiation at phase 12's launch: EXACT_LAUNCH_GAMES
    games of the fixture teams on `fixtures.heads(HEADS_SEED, "reference")`,
    score-only, first held to `nano_game_plain` on EXACT_CHECK games on
    every field (where `check`); held ms, plays, lane share, registers,
    local bytes and blocks resident, and, where the tree's wrapper counts
    them, the walks of each forest and their share of every forest's.
    Copied into an earlier commit's archive it times that commit's
    instantiation the same way."""
    import inspect

    import chip_smoke as cs

    from .. import fixtures
    from ..config import SimConfig
    from ..ops import game
    from ..ops.pack import build_packs

    cfg = SimConfig()
    pack, hp = build_packs(*fixtures.teams(), fixtures.heads(HEADS_SEED, "reference"), cfg, dev)
    args = game.pack_nano_game(pack, cfg, hp)
    n = cs.EXACT_LAUNCH_GAMES
    fo = torch.arange(n, dtype=torch.int32, device=dev) % 2
    none = dict(collect_players=False, collect_stats=False)
    s0 = game.initial_state(n, fo, cfg, dev, **none)
    counted = "walks" in inspect.signature(game.nano_game_cuda).parameters
    walks = torch.zeros(args.exact.forests.shape[0], dtype=torch.int64, device=dev)
    plays = torch.zeros(1, dtype=torch.int64, device=dev)
    iters = torch.zeros(1, dtype=torch.int64, device=dev)
    got = game.nano_game_cuda(args, s0, EXACT_KEY, plays=plays, iters=iters,
                              **(dict(walks=walks) if counted else {}))
    if check:
        m = EXACT_CHECK
        want = game.nano_game_plain(args, game.initial_state(m, fo[:m], cfg, dev, **none),
                                    EXACT_KEY)
        for f in game.GameState._fields:
            if not torch.equal(getattr(got, f)[:m], getattr(want, f)):
                raise RuntimeError(f"nano_game exact: field {f} of the first {m:,} games "
                                   "differs from nano_game_plain")
    kind = game.LAYOUT_KINDS.index("exact")
    regs, local = game.nano_game_usage(kind)
    rec = {"ms": _held(lambda: game.nano_game_cuda(args, s0, EXACT_KEY), EXACT_REPS,
                       "nano_game exact"),
           "plays": int(plays), "lane_share": float(plays) / (32 * float(iters)),
           "registers": regs, "local_bytes": local,
           "blocks": game.nano_geometry(dev.index or 0, False, False, kind)[0]}
    if counted:
        every = int(plays) * sum(tf.n_trees for _, tf, *_ in args.exact.heads)
        rec.update(walks=walks.tolist(), walk_share=float(walks.sum()) / every)
    return {"nano_game exact": rec}


# K1's instantiations with collectors that `_collector_times` times
COLLECTORS = {"nano_game props": (True, True), "nano_game box score": (False, True),
              "nano_game player stats": (True, False)}


def _collector_times(dev: torch.device, cs, cfg, key: int, th, fo) -> Dict[str, dict]:
    """K1 with each combination of collectors (`COLLECTORS`: (players,
    stats)) at LAUNCH_GAMES games of the focus-roster fixture, first held
    to `nano_game_plain` on GAME_CHECK games bit for bit on every field;
    held ms, and for the props instantiation its bound on this launch's
    work (`chip_smoke.accrual_work` of a launch from zero stats)."""
    from .. import fixtures
    from ..matchup import build_direction
    from ..ops import game
    from ..ops.pack import pack_matchup

    fa, fb = fixtures.focus_teams(cs.FOCUS_SEED)
    pack = pack_matchup(build_direction(fa, fb, cfg), build_direction(fb, fa, cfg), dev)
    args = game.pack_nano_game(pack, cfg, th)
    n, m = fo.shape[0], GAME_CHECK
    out = {}
    for name, (players, stats) in COLLECTORS.items():
        coll = dict(collect_players=players, collect_stats=stats)
        small = game.initial_state(m, fo[:m], cfg, dev, **coll)
        want = game.nano_game_plain(args, game.initial_state(m, fo[:m], cfg, dev, **coll), key,
                                    **coll)
        got = game.nano_game_cuda(args, small, key, **coll)
        for f in game.GameState._fields:
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise RuntimeError(f"{name}: field {f} of the first {m:,} games differs from "
                                   "nano_game_plain")
        s = game.initial_state(n, fo, cfg, dev, **coll)
        plays = torch.zeros(1, dtype=torch.int64, device=dev)
        first = game.nano_game_cuda(args, s, key, plays=plays, **coll)
        # the work of this launch from zero stats, before the held calls add on
        bd = (cs.nano_bound(n, int(plays), th.nano_values.numel() * 4,
                            cs.accrual_work(first)) if players and stats else None)
        rec = {"ms": _held(lambda: game.nano_game_cuda(args, s, key, **coll),
                           GAME_REPS["nano_game"], name), "plays": int(plays)}
        if bd is not None:
            rec.update(bound_ms=bd["bound_ms"], bound_class=bd["bound_class"],
                       share=bd["bound_ms"] / rec["ms"])
        out[name] = rec
    return out


# K1's other layouts that `layout_times` times, in turns with the nano one
LAYOUT_RUNS = ("nano_game fused", "nano_game play table", "nano_game per-head",
               "nano_game per-head props", "nano_game forced go")
LAYOUT_HEADS_SEED = 13      # fixtures.heads(13, "small"), as the table-layout tests build


def layout_times(dev: torch.device, cs, cfg, key: int, pack, th, fo) -> Dict[str, dict]:
    """K1 on each other layout at LAUNCH_GAMES games (`LAYOUT_RUNS`): the
    fixture's fused tables on the nano profile, the nano table of
    `fixtures.heads(13, "small")` with its play-policy table, the focus
    roster's per-head tables on the default profiles (score-only and with
    both collectors), a forced go from a 4th-and-2 on the fixture's nano
    table; each first held to `nano_game_plain` on GAME_CHECK games bit for
    bit, then timed in turns with the nano score-only launch (nano,
    layout, layout, nano), beside its bound (`chip_smoke.layout_bound`)."""
    import dataclasses

    from .. import api, fixtures
    from ..matchup import build_direction
    from ..models.tables import nano_profile
    from ..ops import game, rng
    from ..ops import table_lookup as tl
    from ..ops.pack import pack_matchup

    n, m = fo.shape[0], GAME_CHECK
    heads = fixtures.heads(LAYOUT_HEADS_SEED, "small")
    pcfg = cfg.replace(model=dataclasses.replace(cfg.model, use_play_model=True))
    a, b = fixtures.teams()
    fa, fb = fixtures.focus_teams(cs.FOCUS_SEED)
    cm = fixtures.COACH_MAP
    fused = tl.pack_tables(*fixtures.fused_tables(cs.TABLE_SEED), device=dev,
                           fused_prof=nano_profile())
    play = tl.build_table_heads(a, b, heads, pcfg, cm, nano=nano_profile(), device=dev,
                                cache_dir=None)
    ppack = pack_matchup(build_direction(a, b, pcfg, heads, cm),
                         build_direction(b, a, pcfg, heads, cm), dev)
    focus = tl.build_table_heads(fa, fb, heads, cfg, cm, nano=nano_profile(), device=dev,
                                 cache_dir=None)
    fpack = pack_matchup(build_direction(fa, fb, cfg, heads, cm),
                         build_direction(fb, fa, cfg, heads, cm), dev)
    none = dict(collect_players=False, collect_stats=False)
    both = dict(collect_players=True, collect_stats=True)
    fourth = game.Situation(0, 1500, 4, 2.0, 45.0, 10, 14)
    # name: (pack, tables, config, collectors, start situation, force)
    runs = {"nano_game fused": (pack, fused, cfg, none, None, None),
            "nano_game play table": (ppack, play, pcfg, none, None, None),
            "nano_game per-head": (fpack, focus, cfg, none, None, None),
            "nano_game per-head props": (fpack, focus, cfg, both, None, None),
            "nano_game forced go": (pack, th, cfg, none, fourth, "go")}
    nano_args = game.pack_nano_game(pack, cfg, th)
    s_nano = game.initial_state(n, fo, cfg, dev, **none)
    fk = rng.fold_in(key, api.FORCED_PLAY_STREAM)
    out = {}
    for name, (pk, t, c, coll, sit, force) in runs.items():
        args = game.pack_nano_game(pk, c, t)
        kw = dict(coll, force=force, force_key=fk if force else None)

        def start(k):
            if sit is None:
                return game.initial_state(k, fo[:k], c, dev, 0, pk.k, **coll)
            return game.state_from_situation(k, sit, c, dev, 0, pk.k, **coll)

        want = game.nano_game_plain(args, start(m), key, **kw)
        got = game.nano_game_cuda(args, start(m), key, **kw)
        for f in game.GameState._fields:
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise RuntimeError(f"{name}: field {f} of the first {m:,} games differs from "
                                   "nano_game_plain")
        s = start(n)
        plays = torch.zeros(1, dtype=torch.int64, device=dev)
        first = game.nano_game_cuda(args, start(n), key, plays=plays, **kw)
        bd = cs.layout_bound(args, n, int(plays), cs.accrual_work(first)
                             if coll["collect_players"] and coll["collect_stats"] else None)
        turns = {}
        for which in ("nano", name, name, "nano"):
            fn = ((lambda: game.nano_game_cuda(nano_args, s_nano, key)) if which == "nano"
                  else (lambda: game.nano_game_cuda(args, s, key, **kw)))
            turns.setdefault(which, []).append(_held(fn, GAME_REPS["nano_game"], which))
        out[name] = {"ms": min(turns[name]), "turns": turns[name], "nano_turns": turns["nano"],
                     "plays": int(plays), "bound_ms": bd["bound_ms"],
                     "bound_class": bd["bound_class"], "share": bd["bound_ms"] / min(turns[name]),
                     "kind": game.LAYOUT_KINDS[kind_of(game, args, force, coll)]}
        print(f"  {name} ({out[name]['kind']} instantiation): {turns[name]} ms held, nano "
              f"score-only {turns['nano']} in turns; {int(plays) / n:.1f} plays a game")
    return out


def kind_of(game, args, force, coll) -> int:
    """K1's instantiation for a launch (`game.nano_kind`; a tree from
    before the score-only one-row layouts: the layout's, a forced play on
    the nano layout the one-row one)."""
    if hasattr(game, "nano_kind"):
        return game.nano_kind(args, force, **coll)
    return max(args.kind, int(force is not None))


def fused_slate_time(dev: torch.device, cs, cfg, key: int) -> Dict[str, dict]:
    """K1 on the fused layout over a 60-matchup slate (phase 21's: one
    matchup's fixture fused tables on the nano profile packed SLATE_GAMES
    times, 2 x SLATE_CHUNK games a matchup, score-only), first held to
    `nano_game_plain` on GAME_CHECK games of its first matchup bit for bit;
    held ms beside its bound."""
    from .. import fixtures
    from ..matchup import build_direction
    from ..models.tables import nano_profile
    from ..ops import game
    from ..ops import table_lookup as tl
    from ..ops.pack import pack_matchups

    none = dict(collect_players=False, collect_stats=False)
    slate = tl.pack_tables_multi([fixtures.fused_tables(cs.TABLE_SEED)] * cs.SLATE_GAMES, dev,
                                 fused_prof=nano_profile())
    a, b = fixtures.teams()
    spack = pack_matchups([build_direction(a, b, cfg), build_direction(b, a, cfg)]
                          * cs.SLATE_GAMES, dev)
    per = 2 * cs.SLATE_CHUNK
    sn = cs.SLATE_GAMES * per
    t = torch.arange(sn, dtype=torch.int32, device=dev)
    args = game.pack_nano_game(spack, cfg, slate)
    m = GAME_CHECK
    want = game.nano_game_plain(args, game.initial_state(m, t[:m] % 2, cfg, dev, t[:m] // per,
                                                         **none), key)
    got = game.nano_game_cuda(args, game.initial_state(m, t[:m] % 2, cfg, dev, t[:m] // per,
                                                       **none), key)
    for f in game.GameState._fields:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise RuntimeError(f"nano_game fused slate: field {f} of the first {m:,} games "
                               "differs from nano_game_plain")
    s = game.initial_state(sn, t % 2, cfg, dev, t // per, **none)
    plays = torch.zeros(1, dtype=torch.int64, device=dev)
    game.nano_game_cuda(args, s, key, plays=plays)
    bd = cs.layout_bound(args, sn, int(plays))
    ms = _held(lambda: game.nano_game_cuda(args, s, key), GAME_REPS["nano_game slate"],
               "nano_game fused slate")
    return {"nano_game fused slate": {
        "ms": ms, "plays": int(plays), "bound_ms": bd["bound_ms"],
        "bound_class": bd["bound_class"], "share": bd["bound_ms"] / ms,
        "kind": game.LAYOUT_KINDS[kind_of(game, args, None, none)]}}


def sass_functions(text: str) -> Dict[str, list]:
    """{kernel: [instruction text]} of a `cuobjdump -sass` dump."""
    import re

    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def compare_nano_sass(new: Path, old: Path) -> Dict[str, dict]:
    """The nano layout's four instantiations (kLayoutNano x the collectors)
    in the SASS dump `new`, each against its counterpart in `old` (a
    dump of a commit whose kernel took the collectors alone as template
    arguments): instructions each and the lines that differ."""
    import re

    nf, of = sass_functions(new.read_text()), sass_functions(old.read_text())
    out = {}
    for oname, oins in of.items():
        m = re.search(r"nano_game_kernelI(?:Li0E)?Lb(\d)ELb(\d)E", oname)
        if not m:
            continue
        key = f"ILi0ELb{m.group(1)}ELb{m.group(2)}E"
        match = [k for k in nf if key in k]
        if match:
            out[f"stats {m.group(1)}, players {m.group(2)}"] = _sass_diff(nf[match[0]], oins)
    return out


def _sass_diff(nins: list, oins: list) -> dict:
    import difflib

    diff = [ln for ln in difflib.unified_diff(oins, nins, lineterm="", n=0)
            if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
    return {"instructions": len(nins), "old_instructions": len(oins),
            "differing_lines": len(diff), "identical": nins == oins}


def compare_sass_dir(new: Path, old: Path) -> Dict[str, dict]:
    """Every kernel of each dump in the directory `old` (another commit's
    `--sass` output) against the kernel of the same mangled name in this
    run's dump of the same source in `new` (the anonymous namespace's
    hash, which follows the file's bytes, left out), instruction for
    instruction: {"<source> <kernel>": instructions each and the lines that
    differ}."""
    import re

    def named(dump: Path) -> Dict[str, list]:
        return {re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", k): v
                for k, v in sass_functions(dump.read_text()).items()}

    out = {}
    for dump in sorted(old.glob("*.sass")):
        mine = new / dump.name
        if not mine.exists():
            continue
        nf = named(mine)
        for name, oins in named(dump).items():
            if name in nf:
                out[f"{dump.stem} {name}"] = _sass_diff(nf[name], oins)
    return out


def gather_sass_sizes(dump: Path) -> Dict[str, int]:
    """Instructions of each row_gather and row_gather_sum instantiation in
    a `cuobjdump -sass` dump of row_gather.cu, by mangled name."""
    return {name: len(ins) for name, ins in sass_functions(dump.read_text()).items()
            if "row_gather" in name}


def k1_sass_sizes(dump: Path) -> Dict[str, int]:
    """Instructions of each K1 instantiation in a `cuobjdump -sass` dump,
    by its template arguments (layout, stats, players)."""
    import re

    out = {}
    for name, ins in sass_functions(dump.read_text()).items():
        m = re.search(r"nano_game_kernelI(?:Li(\d)E)?Lb(\d)ELb(\d)E", name)
        if m:
            out[f"layout {m.group(1) or 0}, stats {m.group(2)}, players {m.group(3)}"] = len(ins)
    return out


def _held(fn, reps: int, name: str) -> float:
    for _ in range(HELD_TRIES):
        ms, held = held_ms(fn, reps)
        if held:
            return ms
    raise RuntimeError(f"{name}: the hold did not cover the enqueue")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=cuda_build.CSRC, metavar="DIR",
                    help="build from DIR instead of the package's csrc/")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--forests-only", action="store_true", help="time K5 alone")
    only.add_argument("--games-only", action="store_true", help="time K1 and K2 alone")
    only.add_argument("--gathers-only", action="store_true",
                      help="time row_gather and row_gather_sum alone")
    only.add_argument("--exact-only", action="store_true",
                      help="time K1's exact instantiation alone (exact_time)")
    ap.add_argument("--no-check", action="store_true",
                    help="with --exact-only, time without holding the launch to nano_game_plain")
    ap.add_argument("--sass", type=Path, metavar="DIR",
                    help="write the SASS of each source it builds into DIR")
    ap.add_argument("--sass-against", type=Path, metavar="PATH",
                    help="compare the nano instantiations' SASS with FILE's, or, given a "
                         "directory of another commit's --sass output, every kernel of it "
                         "with the kernel of the same name here (needs --sass)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernels: this probe needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    csrc = args.csrc.resolve()
    timed = (("forest_eval",) if args.forests_only else GAME_SOURCES if args.games_only
             else GATHER_SOURCES if args.gathers_only
             else ("nano_game",) if args.exact_only else SOURCES)
    t0 = time.perf_counter()
    libs = dict(zip(timed, cuda_build.load_kernel_libraries(*timed, csrc=csrc)))
    build_s = time.perf_counter() - t0
    print(f"  built or loaded {', '.join(timed)} in {build_s:.1f} s (one nvcc a source, "
          "together; a cached build loads)")
    usage = {}
    for name in timed:
        sass = None
        if args.sass is not None:
            args.sass.mkdir(parents=True, exist_ok=True)
            sass = args.sass / f"{name}.sass"
        usage.update(cuda_build.ptxas_usage(name, csrc, sass))
    for kernel, u in usage.items():
        print(f"  {kernel}: {u['registers']} registers, spill stores {u['spill_stores']} B, "
              f"spill loads {u['spill_loads']} B")
    sass_cmp = {}
    if args.sass is not None and args.sass_against is not None and args.sass_against.is_dir():
        sass_cmp = compare_sass_dir(args.sass, args.sass_against)
        for what, c in sass_cmp.items():
            print(f"  {what}: {c['instructions']} instructions against "
                  f"{c['old_instructions']}, {'identical' if c['identical'] else 'differing'} "
                  f"({c['differing_lines']} lines of the diff)")
    elif args.sass is not None and args.sass_against is not None and "nano_game" in timed:
        sass_cmp = compare_nano_sass(args.sass / "nano_game.sass", args.sass_against)
        for what, c in sass_cmp.items():
            print(f"  nano_game nano layout, {what}: {c['instructions']} instructions against "
                  f"{c['old_instructions']}, {'identical' if c['identical'] else 'differing'} "
                  f"({c['differing_lines']} lines of the diff)")
    sizes = {}
    if args.sass is not None and "row_gather" in timed:
        sizes["gather"] = gather_sass_sizes(args.sass / "row_gather.sass")
        for kernel, count in sizes["gather"].items():
            print(f"  {kernel}: {count} SASS instructions")
    if args.sass is not None and "nano_game" in timed:
        k1 = {"this": k1_sass_sizes(args.sass / "nano_game.sass")}
        if args.sass_against is not None:
            k1["against"] = k1_sass_sizes(args.sass_against if args.sass_against.is_file()
                                          else args.sass_against / "nano_game.sass")
        for which, by in k1.items():
            for inst, count in by.items():
                print(f"  nano_game SASS ({which}), {inst}: {count} instructions")
        sizes.update(k1)
    dev = torch.device("cuda")
    names = [n for n in RUNS if "row0" in (csrc / "philox_draws.cu").read_text()
             or not n.startswith("philox")]
    times, games, yard = {}, {}, {}
    if args.exact_only:
        games = exact_time(dev, not args.no_check)
        g = games["nano_game exact"]
        print(f"  nano_game exact: {g['plays']:,} plays, lane share {g['lane_share']:.4f}, "
              f"{g['registers']} registers, {g['local_bytes']} local bytes, {g['blocks']} "
              "blocks resident" + (f", {g['walk_share']:.1%} of every forest's walks read"
                                   if "walk_share" in g else "") + f" ({card})")
    elif not (args.forests_only or args.games_only):
        paths = list(PATH_STEPS)
        if args.gathers_only:
            names = [n for n in names if n.startswith("row_gather")]
            paths = [n for n in paths if n.startswith(("B3", "B5"))]
        times.update({**kernel_times(dev, names), **path_times(dev, paths)})
        yard = gather_yardsticks(dev)
    if not (args.games_only or args.gathers_only or args.exact_only):
        times.update(forest_times(dev, libs["forest_eval"]))
    if not (args.forests_only or args.gathers_only or args.exact_only):
        games = game_times(dev)
    times.update({name: g["ms"] for name, g in games.items()})
    times["launch gap"] = launch_gap_ms()
    for name, ms in times.items():
        print(f"  {name}: {ms:.5f} ms held ({card})")
    gap = times["launch gap"]
    for what, y in yard.items():
        ms = times[f"row_gather {what}"]
        print(f"  row_gather {what}: {ms:.5f} ms held, {ms - gap:.5f} above the launch gap, "
              f"index_select {y['index_select']:.5f}, bound {y['bound_ms']:.5f} ms (bytes), "
              f"{y['bound_ms'] / ms:.1%} of it ({card})")
    for name, g in games.items():
        if "bound_ms" not in g:
            continue
        extra = "".join(f", {k} {g[k]:.4f}" for k in ("lane_share", "lane_share_one_a_thread")
                        if k in g)
        print(f"  {name}: bound {g['bound_ms']:.5f} ms ({g['bound_class']}), "
              f"{g['share']:.1%} of it{extra} ({card})")
    print(json.dumps({"csrc": str(csrc), "card": card, "held_ms": times, "games": games,
                      "gathers": yard, "registers": usage, "sass": sass_cmp, "sass_sizes": sizes,
                      "build_s": build_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
