"""Command-line entry points: port of fast_monte_carlo_tpu/cli.py.

    python -m fast_monte_carlo_tpu_torch.cli sim "Team A" "Team B" \\
        --sp sp.csv --artifacts tests/data/torch_artifacts -n 1000 --save
    python -m fast_monte_carlo_tpu_torch.cli slate --games games.csv --sp sp.csv -n 10000
    python -m fast_monte_carlo_tpu_torch.cli serve --sp sp.csv --artifacts DIR

Subcommands, flags and defaults are the JAX CLI's; each ported subcommand
adds `--device` (default `cuda`; `cpu` for a host without a card, where
`cuda` raises).  Ported: `sim`, `live`, `fourth`, `parlay`, `slate` (the
summary loop, `--lines`, `--batched`, `--shard game` and `--props`),
`season`, `edges`, `prop`, `backtest` and `serve`.  They read CSVs with the
`csv` module and print the JAX commands' lines; where the JAX command
prints a DataFrame, `_frame_text` prints the same columns in the same
order, laid out as pandas lays them out.

`edges` keeps the JAX CLI's `--device` switch between its two branches:
without it the markets are priced from saved sim files (`edge.find_edges`
and the ladders and middles over `scores_*`/`players_*`); a bare
`--device` simulates and prices on the card, `--device cpu` on the CPU.
`prop` prices one player prop (and its ladder) from a saved players file.

`sim --sd-mode` takes every sd mode of the JAX CLI: `cachewarm` plays its
CPU-oracle warm-up games on the host before the table build, and keeps
them, with the tables, in the table disk cache (`.table_cache/`).

`--shard` (on `sim`, `live`, `parlay`, `edges --device`, `season`,
`backtest` and `serve`; `slate --shard trial|game`) splits the games over
the ranks of `parallel.mesh.trial_group`: a plain command runs in a world
of one, and

    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m fast_monte_carlo_tpu_torch.cli sim "Team A" "Team B" --sp sp.csv --shard

runs N ranks, one a card.  Every rank runs the same calls; only rank 0
prints and writes files (`--save`), and a server's rank 0 answers HTTP.

`bench` runs the port's bench entry (`fast_monte_carlo_tpu_torch/bench.py`)
in a subprocess.  `train` is not ported: it raises (ROADMAP.md,
`train/pipeline.py`).
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import json
import math
import os
import re
import sys
import time

import numpy as np

from .models.heads import DEFAULT_ARTIFACT_DIR

def _read_games(path: str) -> list:
    """The first two columns of a CSV's rows after its header, as
    (team_a, team_b) tuples (pandas' `read_csv(path).iloc[:, :2]`)."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    return [tuple(r[:2]) for r in rows[1:]]


def _read_rows(path: str) -> list:
    """A CSV's rows as dicts by header, cells as pandas' read_csv types
    them (`data.columns.read_csv_columns`)."""
    from .data.columns import read_csv_columns, records_of

    return records_of(read_csv_columns(path))


_DECIMAL_NUMBER = re.compile(r"^\s*[\+-]?[0-9]+\.[0-9]*$")


def _trim_zeros(cells: list) -> list:
    """pandas' `_trim_zeros_float`: the trailing zeros every decimal number
    of a column shares trimmed, one kept after the point."""
    def dec(x):
        return _DECIMAL_NUMBER.match(x) is not None

    while any(dec(x) for x in cells) and all(x.endswith("0") for x in cells if dec(x)):
        cells = [x[:-1] if dec(x) else x for x in cells]
    return [x + "0" if dec(x) and x.endswith(".") else x for x in cells]


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(
        v, (bool, np.bool_))


def _column_text(vals, leading_space: bool):
    """(cells, numeric) of one column as pandas prints it: integers as
    integers; floats (ints among them, NaN as NaN) with six places, the
    trailing zeros every cell shares trimmed, in e-notation where a value is
    below 1e-6 or, too long, above 1e6; anything else as str.  With
    `leading_space` (pandas does so when it prints the index) a cell keeps a
    place for the sign.  `numeric` says whether pandas would give the
    column a numeric dtype, whose header it prints with a leading space."""
    pad = " " if leading_space else ""
    if vals and all(_is_number(v) for v in vals):
        if all(isinstance(v, (int, np.integer)) for v in vals):
            return [f"{v: d}" if leading_space else f"{v:d}" for v in vals], True
        nums = [float(v) for v in vals]
        cells = _trim_zeros(["NaN" if math.isnan(v) else format(v, f"{pad}.6f")
                             for v in nums])
        finite = [abs(v) for v in nums if not math.isnan(v)]
        small = any(0 < v < 1e-6 for v in finite)
        if small or (max(map(len, cells)) > 12 and any(v > 1e6 for v in finite)):
            cells = ["NaN" if math.isnan(v) else format(v, f"{pad}.6e") for v in nums]
        return cells, True
    numeric = bool(vals) and all(isinstance(v, (bool, np.bool_)) for v in vals)
    return [pad + ("NaN" if isinstance(v, float) and math.isnan(v) else str(v))
            for v in vals], numeric


def _frame_text(columns: dict, index=None, index_name=None) -> str:
    """A table of `columns` (name -> values) as pandas prints a DataFrame:
    with `index`, as `to_string()` (its labels left-aligned before the
    columns and, with `index_name`, a line naming it under the header);
    without, as `to_string(index=False)`."""
    names = list(columns)
    lead = index is not None
    texts = [_column_text([v.item() if hasattr(v, "item") else v for v in columns[c]], lead)
             for c in names]
    n = len(texts[0][0]) if texts else 0
    blocks = []
    if lead:
        labels = [str(x) for x in index]
        head = ["", str(index_name)] if index_name else [""]
        iw = max(len(x) for x in head + labels)
        blocks.append([x.ljust(iw) for x in head + labels])
    for c, (cells, numeric) in zip(names, texts):
        head = [(" " if numeric else "") + str(c)] + ([""] if lead and index_name else [])
        w = max(len(x) for x in head + cells)
        blocks.append([x.rjust(w) for x in head + cells])
    return "\n".join(" ".join(b[i] for b in blocks) for i in range(len(blocks[0])))


def _rows_text(rows: list) -> str:
    """Row dicts as `pd.DataFrame(rows).to_string(index=False)` prints them."""
    cols = list(dict.fromkeys(k for r in rows for k in r))
    return _frame_text({c: [r.get(c, math.nan) for r in rows] for c in cols})


def _agreed_reads(args, fn):
    """fn(), a command's reads of its input files before its first launch,
    under one `agree` over the ranks where the command runs as several
    (`torchrun`; `parallel.mesh.agree`): a rank that fails to read fails
    every rank there instead of leaving the others waiting in the first
    collective.  In a world of one, fn() alone."""
    from .api import _agreed
    from .parallel.mesh import world_size

    return _agreed(world_size() > 1, args.device, fn)


def _cmd_sim(args) -> int:
    from .api import csv_base_from, simulate_upcoming_matchup_columns
    from .parallel.mesh import process_rank

    cfg = None
    heads = None
    if args.reconstructed:
        # full-fidelity reconstructed mode: recovered ML play policy +
        # repo-trained stage-2 + non-unit temperature overlay
        from .config import reconstructed_config
        from .models.heads import load_reconstructed_heads
        cfg = reconstructed_config()
        heads = _agreed_reads(args, lambda: load_reconstructed_heads(args.artifacts))
    if args.sd_mode != "axis":
        import dataclasses

        from .config import SimConfig
        cfg = cfg or SimConfig()
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, sd_mode=args.sd_mode))
    # only rank 0 writes the frames
    save = (csv_base_from(args.team_a, args.team_b, args.week)
            if args.save and process_rank() == 0 else None)
    scores, _, summary, _, _, meta = simulate_upcoming_matchup_columns(
        args.team_a, args.team_b, year=args.year, week=args.week,
        sp_path=args.sp, artifact_dir=args.artifacts, focus_csv=args.focus,
        n=args.n, collect_players=args.players, save_csv=save, mode=args.mode,
        seed=args.seed, shard=args.shard, cfg=cfg, heads=heads, device=args.device)
    print(_frame_text({c: v for c, v in summary.items() if c != "team"},
                      index=summary["team"], index_name="team"))
    pairs = max(1, len(scores["team"]) // 2)
    print(f"\nTiming: {meta['total_time_sec']:.2f}s total | {pairs} sims "
          f"| {pairs/meta['total_time_sec']:.2f} sims/sec "
          f"| sim-only {meta['sim_time_sec']:.2f}s | I/O {meta['io_time_sec']:.2f}s")
    if save:
        print(f"saved scores_{save} / players_{save}")
    return 0


def _cmd_live(args) -> int:
    """In-game win probability from a mid-game situation."""
    from .api import simulate_live_game, situation_from_fields
    from .config import SimConfig
    from .edge import market_odds_from_summary, summary_moneyline

    sa, sb = (int(v) for v in args.score.split("-"))
    sit = situation_from_fields(
        ytg=args.ytg, offense=args.offense, sec=args.sec,
        quarter=args.quarter, clock=args.clock, down=args.down,
        dist=args.dist, score_a=sa, score_b=sb)
    sec, offense = sit.sec, sit.offense
    row, summary = simulate_live_game(
        args.team_a, args.team_b, sit, sp_path=args.sp, year=args.year,
        week=args.week, n_games=args.n, artifact_dir=args.artifacts,
        focus_csv=args.focus, mode=args.mode, table_quality=args.quality,
        seed=args.seed, shard=args.shard, device=args.device)
    qsec = SimConfig().clock.quarter_seconds
    qtr = 4 - (int(sec) - 1) // qsec      # the engine's own period formula
    clock = int(sec) - (4 - qtr) * qsec   # seconds left in that quarter
    print(f"{args.team_a} {sa} - {sb} {args.team_b} | "
          f"Q{qtr} {clock // 60}:{clock % 60:02d} | "
          f"{'AB'[offense]} ball, down {args.down} & {args.dist:g} "
          f"at ytg {args.ytg:g}")
    print(f"win: {args.team_a} {row['win_a']:.3f} / {args.team_b} "
          f"{row['win_b']:.3f} / tie {row['tie']:.3f}   "
          f"(n={row['n_games']})")
    print(f"proj: {row['mean_a']:.1f} - {row['mean_b']:.1f} "
          f"(margin {row['mean_margin_a']:+.1f}, total {row['mean_total']:.1f})")
    ml = summary_moneyline(summary, args.team_a, args.team_b)
    print(f"fair moneyline: {ml}")
    if args.spread is not None or args.total is not None:
        print(market_odds_from_summary(summary, args.team_a, args.team_b,
                                       spread=args.spread, total=args.total))
    return 0


def _cmd_fourth(args) -> int:
    """4th-down decision chart: forced go/FG/punt win probabilities next to
    the engine's sampled policy."""
    from .api import evaluate_fourth_down, situation_from_fields

    sa, sb = (int(v) for v in args.score.split("-"))
    sit = situation_from_fields(
        ytg=args.ytg, offense=args.offense, sec=args.sec,
        quarter=args.quarter, clock=args.clock, down=4,
        dist=args.dist, score_a=sa, score_b=sb)
    sec, offense = sit.sec, sit.offense
    res = evaluate_fourth_down(
        args.team_a, args.team_b, sit, sp_path=args.sp, year=args.year,
        week=args.week, n_games=args.n, artifact_dir=args.artifacts,
        focus_csv=args.focus, mode=args.mode, table_quality=args.quality,
        seed=args.seed, device=args.device)
    off_team = (args.team_a, args.team_b)[offense]
    print(f"{args.team_a} {sa} - {sb} {args.team_b} | 4th & {args.dist:g} "
          f"at ytg {args.ytg:g}, {sec}s left | {off_team} ball")
    for choice in ("policy", "go", "fg", "punt"):
        if choice not in res["choices"]:
            continue
        row = res["choices"][choice]
        extra = (f"  (make prob {row['fg_make_prob']:.2f})"
                 if choice == "fg" else "")
        mark = "  <-- best" if choice == res["best"] else ""
        print(f"  {choice:<7s} win({off_team}) {row['win_off']:.4f}   "
              f"margin {row['mean_margin_off']:+.2f}{extra}{mark}")
    print(f"  best {res['best']} vs policy: {res['best_vs_policy_pp']:+.2f}pp"
          f"   (MC scale ~{res['se_pp']:.2f}pp/choice; deltas are "
          "CRN-paired)")
    return 0


def _cmd_parlay(args) -> int:
    """Same-game parlay pricing off the joint per-trial distribution."""
    from .api import simulate_parlay_core
    from .edge import print_parlay_readable
    from .serve import corr_records, jsonable

    def read_legs():
        if not args.legs.startswith("@"):
            return args.legs
        with open(args.legs[1:]) as f:
            return f.read()

    legs = json.loads(_agreed_reads(args, read_legs))
    if not isinstance(legs, list):
        raise SystemExit("--legs must be a JSON array of leg objects "
                         "(or @path to one)")
    if args.tease is not None:
        from .edge import tease_legs
        legs = tease_legs(legs, args.tease)
        print(f"[teaser: every leg moved {args.tease:+g} points in the "
              "bettor's favor; pushes void and reduce]")
    rr = None
    if args.rr is not None:
        try:
            rr = [int(k) for k in args.rr.split(",")]
        except ValueError:
            raise SystemExit(f"--rr wants a size or comma list of sizes "
                             f"(e.g. 2 or 2,3), got {args.rr!r}")
    res = simulate_parlay_core(
        args.team_a, args.team_b, legs, sp_path=args.sp, year=args.year,
        week=args.week, n_pairs=args.n, artifact_dir=args.artifacts,
        focus_csv=args.focus, mode=args.mode, table_quality=args.quality,
        seed=args.seed, shard=args.shard, price=args.price, correlations=args.corr,
        round_robin=rr, device=args.device)
    print_parlay_readable(res)
    if args.corr:
        labels, corr = res["leg_corr"]
        print("\nLeg win-indicator correlations:")
        print(_frame_text({lab: [round(float(v), 3) for v in corr[:, j]]
                           for j, lab in enumerate(labels)}, index=labels))
        res["leg_corr"] = corr_records(labels, corr)
    if rr is not None:
        from .edge import print_round_robin_readable
        print_round_robin_readable(res["round_robin"])
    if args.json:
        print(json.dumps(jsonable(res)))
    return 0


def _slate_contexts(args, games):
    """Build (team_a, team_b) contexts + heads once for the SlateRunner
    branches of `slate` (game-sharded and batched share this block)."""
    from .data.context import build_team_context_from_sp_flex
    from .data.sp import load_sp_flex
    from .models.heads import load_heads

    sp = load_sp_flex(args.sp)
    ms = [(build_team_context_from_sp_flex(a, args.year, args.week, sp),
           build_team_context_from_sp_flex(b, args.year, args.week, sp))
          for a, b in games]
    return ms, load_heads(args.artifacts)


def _cmd_slate(args) -> int:
    if args.lines and args.batched and args.shard == "none":
        # fail before simulating: the batched path has no device-histogram
        # summaries, so it cannot price markets
        print("--lines needs a summary slate path (drop --batched, or use "
              "--shard trial|game); no simulation run")
        return 2
    games, lines = _agreed_reads(args, lambda: (
        _read_games(args.games), _read_rows(args.lines) if args.lines else None))
    summaries = None
    t0 = time.perf_counter()
    if args.shard == "trial" or (lines is not None and not args.batched
                                 and args.shard == "none"):
        # per-matchup launches, each split over the ranks with 'trial';
        # --lines also routes the unsharded default here: market pricing
        # needs the device-histogram summaries this path accumulates
        from .api import simulate_slate_summary_rows
        rows, summaries = simulate_slate_summary_rows(
            games, sp_path=args.sp, year=args.year, week=args.week,
            n_pairs=args.n, artifact_dir=args.artifacts, mode=args.mode,
            table_quality=args.quality, shard=args.shard == "trial", device=args.device)
    elif args.shard == "game":
        # the game layout: each rank builds and holds a block of the
        # matchups' tables and plays the block in launches of all of them
        from .api import SlateRunner

        ms, heads = _agreed_reads(args, lambda: _slate_contexts(args, games))
        sr = SlateRunner(ms, heads, quality=args.quality, game_shard=True, device=args.device)
        rows, summaries = sr.run_summary_rows(args.n)
    elif args.batched:
        from .api import SlateRunner

        ms, heads = _slate_contexts(args, games)
        sr = SlateRunner(ms, heads,
                         quality=args.quality if args.quality in
                         ("turbo", "nano", "fused") else "fused", device=args.device)
        rows = sr.summary_rows(sr.run(args.n))
    else:
        from .api import simulate_slate_rows
        rows = simulate_slate_rows(games, sp_path=args.sp, year=args.year, week=args.week,
                                   n=args.n, artifact_dir=args.artifacts, mode=args.mode,
                                   table_quality=args.quality, device=args.device)
    print(_rows_text(rows))
    total_games = int(sum(r["n_games"] for r in rows))
    dt = time.perf_counter() - t0
    print(f"\n{len(games)} matchups x {args.n} pairs = {total_games} games "
          f"in {dt:.1f}s ({total_games/dt:,.0f} games/s incl. table builds)")
    if lines is not None:
        from .edge import print_slate_edges, slate_market_rows
        print_slate_edges(slate_market_rows(games, summaries, lines))
    if args.props:
        from .api import simulate_slate_prop_rows
        from .edge import print_prop_table
        print_prop_table(simulate_slate_prop_rows(
            games, sp_path=args.sp, props_csv=args.props, year=args.year,
            week=args.week, n_pairs=args.props_n, mode=args.mode,
            artifact_dir=args.artifacts, table_quality=args.quality,
            focus_csv=args.focus, min_abs_edge_pct=args.min_edge,
            shard=args.shard == "trial", device=args.device))
    return 0


def _cmd_season(args) -> int:
    """Season win-total projection: per-game slate sims -> exact
    Poisson-binomial win-count distribution (api.project_season_rows)."""
    from .api import project_season_rows
    from .edge import print_season_readable

    if (args.opponents is None) == (args.games is None):
        print("pass exactly one of --opponents or --games; no simulation run")
        return 2
    opps = ([s.strip() for s in args.opponents.split(",") if s.strip()]
            if args.opponents else None)
    games = _agreed_reads(args, lambda: _read_games(args.games) if args.games else None)
    t0 = time.perf_counter()
    res = project_season_rows(
        args.team, opponents=opps, games=games, line=args.line,
        sp_path=args.sp, year=args.year, week=args.week, n_pairs=args.n,
        artifact_dir=args.artifacts, mode=args.mode,
        table_quality=args.quality, seed=args.seed, shard=args.shard, device=args.device)
    dt = time.perf_counter() - t0
    sched = res["schedule"]
    for row in sched:
        us, them = (("mean_a", "mean_b") if row["team_side"] == "a"
                    else ("mean_b", "mean_a"))
        print(f"  vs {str(row['opponent']):<24s} p_win "
              f"{row['p_win_team']:.4f}  (proj {row[us]:.1f}-{row[them]:.1f})")
    print_season_readable(res)
    total = int(sum(r["n_games"] for r in sched))
    print(f"\n[{len(sched)} matchups x {args.n} pairs = {total} games "
          f"in {dt:.1f}s]")
    return 0


def _cmd_serve(args) -> int:
    """Run the resident simulation service (see serve.py)."""
    from .serve import ServeConfig, serve_forever

    warm_games = _agreed_reads(args, lambda: _read_games(args.warm) if args.warm else None)
    serve_forever(
        ServeConfig(sp_path=args.sp, artifact_dir=args.artifacts,
                    year=args.year, week=args.week, mode=args.mode,
                    table_quality=args.quality, focus_csv=args.focus,
                    shard=args.shard, max_n_pairs=args.max_pairs,
                    max_games=args.max_games, deadline_s=args.deadline,
                    aot_dir=args.aot, device=args.device),
        host=args.host, port=args.port, warm_games=warm_games)
    return 0


def _parse_line_pair(spec: str, flag: str):
    """Parse a LOW,HIGH line pair for the middle flags."""
    try:
        lo, hi = (float(x) for x in spec.split(","))
    except ValueError:
        raise SystemExit(
            f"{flag} wants two comma-separated lines (e.g. -3.5,7.5), "
            f"got {spec!r}")
    return lo, hi


def _middle_specs(args):
    """The (mid_spread, mid_total) kwargs both edges paths share."""
    return dict(
        mid_spread=(None if args.mid_spread is None else
                    _parse_line_pair(args.mid_spread, "--mid-spread")),
        mid_total=(None if args.mid_total is None else
                   _parse_line_pair(args.mid_total, "--mid-total")))


def _cmd_edges(args) -> int:
    if args.device is not None:
        return _cmd_edges_device(args)
    mids = _middle_specs(args)  # bad --mid specs fail before any pricing
    want_mid = any(v is not None for v in mids.values())
    from .edge import find_edges
    if (args.spread is not None or args.total is not None
            or args.props is not None or not want_mid):
        # a middles-only call skips the main report (game_market_odds
        # refuses to price without a quoted line); any other call, a
        # middles+props one too, prints spread/total/ML/props
        find_edges(csv_base=args.base, team_a=args.team_a,
                   team_b=args.team_b, spread=args.spread, total=args.total,
                   props_csv=args.props, directory=args.dir)
    want_alt = args.alt and (args.spread is not None
                             or args.total is not None)
    if want_alt or want_mid:
        from .edge import find_saved_files, read_table_columns
        scores_path, _ = find_saved_files(args.base, team_a=args.team_a,
                                          team_b=args.team_b,
                                          directory=args.dir)
        sims = read_table_columns(scores_path)
    if want_alt:
        from .edge import alt_line_rows_from_sims, print_alt_lines
        print_alt_lines(alt_line_rows_from_sims(
            sims, args.team_a, args.team_b,
            spread=args.spread, total=args.total, width=args.alt_width,
            step=args.alt_step))
    if want_mid:
        from .edge import middles_from_sims, print_middle_readable
        for res in middles_from_sims(sims, args.team_a, args.team_b,
                                     **mids).values():
            print_middle_readable(res)
    return 0


def _cmd_prop(args) -> int:
    """One player prop off saved sims (players_* table), optionally with
    the alternate-line ladder around the quote."""
    from .edge import _players_for, player_prop_ladder_rows, player_prop_odds

    # the quote and its ladder price the same samples: the file read once
    players = _players_for(args.base, args.team, args.dir)
    res = player_prop_odds(args.base, args.team, args.player, args.stat,
                           args.line, role=args.role, directory=args.dir,
                           players_df=players)
    print(f"\n=== {res['player']} ({res['team']}, {res['role']}) "
          f"{res['stat']} {res['line']:g} ===")
    print(f"  Over:  {res['p_over']:.1%} fair {res['american_over']:+d}   "
          f"Under: {res['p_under']:.1%} fair {res['american_under']:+d}"
          + (f"   push {res['push_rate']:.1%}" if res["push_rate"] else ""))
    print(f"  mean {res['mean']:.1f}  median {res['median']:.1f}  "
          f"p75 {res['p75']:.1f}  p90 {res['p90']:.1f}")
    print(f"  Best side at -110: {res['best_side']} "
          f"(edge {res['edge']:+.2f}%, EV ${res['ev_per_$100']:+.2f}/$100)")
    if args.ladder:
        rows = player_prop_ladder_rows(args.base, args.team, args.player,
                                       args.stat, args.line, role=args.role,
                                       directory=args.dir, players_df=players,
                                       width=args.width, step=args.step, price=args.price)
        print("\nAlternate lines (same samples as the quote):")
        print(_rows_text([{k: v for k, v in r.items() if k not in ("team", "player", "stat")}
                          for r in rows]))
    return 0


def _cmd_edges_device(args) -> int:
    """Simulate and price in one process, on `--device` (the card for a
    bare flag): spread, total and moneyline from the score histograms,
    props from the player stats, no file written."""
    from .api import _prepared_runner, host_summaries
    from .edge import (market_odds_from_summary, print_game_market_readable,
                       print_prop_table, scan_props_rows)
    from .parallel import summarize_scores

    if not args.sp:
        print("edges --device needs --sp (it simulates in-process)",
              file=sys.stderr)
        return 2
    mids = _middle_specs(args)  # bad --mid specs fail before the sim runs
    runner, a, b, _ = _prepared_runner(
        args.team_a, args.team_b, sp_path=args.sp, year=args.year, week=args.week,
        artifact_dir=args.artifacts, focus_csv=args.focus, mode=args.mode,
        table_quality=args.quality, cfg=None, shard=args.shard, device=args.device)
    want_players = bool(args.props)
    t0 = time.perf_counter()
    if args.n > 65536 and not want_players:
        # a large market-only scan: launches of 32,768 pairs whose moments
        # accumulate on the device (n rounds up to whole launches); props
        # need every game's player stats, so they run one launch
        summary = runner.run_pairs_summary(args.n, seed=args.seed)
    else:
        out = runner.run_pairs(args.n, seed=args.seed,
                               collect_players=want_players,
                               collect_stats=False)
        summary = summarize_scores(out.score)
    summary, = host_summaries(summary)   # the markets read it: one copy
    n_games = int(summary.n)
    dt = time.perf_counter() - t0
    res = market_odds_from_summary(summary, args.team_a, args.team_b,
                                   spread=args.spread, total=args.total)
    print_game_market_readable(res)
    if args.alt and (args.spread is not None or args.total is not None):
        from .edge import alt_line_rows_from_summary, print_alt_lines
        print_alt_lines(alt_line_rows_from_summary(
            summary, args.team_a, args.team_b, spread=args.spread,
            total=args.total, width=args.alt_width, step=args.alt_step))
    if any(v is not None for v in mids.values()):
        from .edge import middles_from_summary, print_middle_readable
        for r in middles_from_summary(summary, args.team_a, args.team_b,
                                      **mids).values():
            print_middle_readable(r)
    if args.props:
        print_prop_table(scan_props_rows(out, a, b, args.props))
    print(f"\n[{n_games} games simulated + reduced on "
          f"{runner.device.type} in {dt:.2f}s]")
    return 0


def _cmd_backtest(args) -> int:
    """Score the simulator against real finals (backtest.py): win-prob
    calibration, point accuracy and PIT distribution checks."""
    from .backtest import backtest_slate_report, print_backtest_readable
    from .data.columns import read_csv_columns, records_of

    table, games = _agreed_reads(args, lambda: (
        read_csv_columns(args.results), _read_games(args.games) if args.games else None))
    need = {"team_a", "team_b", "score_a", "score_b"}
    if not need <= set(table):
        print(f"--results needs columns {sorted(need)}, got {list(table)}")
        return 2
    results = records_of(table)
    if not args.games:
        games = [(r["team_a"], r["team_b"]) for r in results]
    rep = backtest_slate_report(
        games, results, sp_path=args.sp, year=args.year, week=args.week,
        n_pairs=args.n, artifact_dir=args.artifacts, mode=args.mode,
        table_quality=args.quality, seed=args.seed, shard=args.shard, bins=args.bins,
        device=args.device)
    print_backtest_readable(rep)
    return 0


def _cmd_bench(args) -> int:
    """`python -m fast_monte_carlo_tpu_torch.bench --mode M -n N --device D`
    in a subprocess, as the JAX CLI runs `bench.py`: its one JSON line on
    stdout, its exit code returned."""
    import subprocess
    return subprocess.call([sys.executable, "-m", "fast_monte_carlo_tpu_torch.bench",
                            "--mode", args.mode, "-n", str(args.n), "--device", args.device])


def _cmd_train(args) -> int:
    raise NotImplementedError("train: offline training is outside the port's scope "
                              "(ROADMAP.md: train/pipeline.py); train with the JAX "
                              "package and read its artifacts with --artifacts")


def _arg_offense(s: str) -> str:
    """argparse validator: clean error instead of a KeyError traceback."""
    if s.strip().lower() not in ("a", "b"):
        raise argparse.ArgumentTypeError(f"offense must be A or B, got {s!r}")
    return s


def _arg_score(s: str) -> str:
    parts = s.split("-")
    if len(parts) != 2 or not all(p.strip().isdigit() for p in parts):
        raise argparse.ArgumentTypeError(
            f"score must look like 21-17, got {s!r}")
    return s


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fast_monte_carlo_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sim", help="simulate one matchup")
    ps.add_argument("team_a")
    ps.add_argument("team_b")
    ps.add_argument("--sp", required=True, help="SP+ csv path (schema A or B)")
    ps.add_argument("-n", type=int, default=1000, help="number of PAIRS")
    ps.add_argument("--year", type=int, default=2025)
    ps.add_argument("--week", type=int, default=1)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--mode", default="table", choices=["table", "exact", "analytic"])
    ps.add_argument("--artifacts", default=DEFAULT_ARTIFACT_DIR)
    ps.add_argument("--focus", default=None, help="focus players csv")
    ps.add_argument("--players", action="store_true", help="collect player stats")
    ps.add_argument("--save", action="store_true")
    ps.add_argument("--shard", action="store_true",
                    help="shard the trial axis over all devices")
    ps.add_argument("--reconstructed", action="store_true",
                    help="full-fidelity reconstructed mode: recovered ML "
                         "play policy + repo-trained stage-2 + non-unit "
                         "temperature (config.reconstructed_config + the "
                         "committed artifact overlay)")
    ps.add_argument("--sd-mode", default="axis", dest="sd_mode",
                    choices=["axis", "frozen", "marginal", "cachewarm"],
                    help="score_diff treatment for the table heads "
                         "(EngineConfig.sd_mode; see config.py notes)")
    _add_device(ps)
    ps.set_defaults(fn=_cmd_sim)

    pg = sub.add_parser(
        "live", help="in-game win probability from a mid-game state")
    pg.add_argument("team_a")
    pg.add_argument("team_b")
    pg.add_argument("--sp", required=True, help="SP+ csv path")
    pg.add_argument("--offense", default="A", type=_arg_offense,
                    help="side with the ball: A or B")
    pg.add_argument("--sec", type=int, default=None,
                    help="seconds remaining in the GAME (overrides "
                         "--quarter/--clock)")
    pg.add_argument("--quarter", type=int, default=1, choices=[1, 2, 3, 4])
    pg.add_argument("--clock", default=None,
                    help="MM:SS remaining in the quarter (default 15:00)")
    pg.add_argument("--down", type=int, default=1, choices=[1, 2, 3, 4])
    pg.add_argument("--dist", type=float, default=10.0,
                    help="yards to the first-down marker")
    pg.add_argument("--ytg", type=float, required=True,
                    help="yards to the opponent goal line (1-99)")
    pg.add_argument("--score", default="0-0", type=_arg_score,
                    help="current score as A-B, e.g. 21-17")
    pg.add_argument("-n", type=int, default=65536, help="number of GAMES")
    pg.add_argument("--spread", type=float, default=None,
                    help="live spread quote (team A perspective)")
    pg.add_argument("--total", type=float, default=None,
                    help="live total quote")
    pg.add_argument("--year", type=int, default=2025)
    pg.add_argument("--week", type=int, default=1)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--mode", default="table",
                    choices=["table", "exact", "analytic"])
    pg.add_argument("--quality", default="nano")
    pg.add_argument("--focus", default=None)
    pg.add_argument("--artifacts", default=DEFAULT_ARTIFACT_DIR)
    pg.add_argument("--shard", action="store_true",
                    help="shard the trial axis over all devices")
    _add_device(pg)
    pg.set_defaults(fn=_cmd_live)

    pf = sub.add_parser(
        "fourth", help="4th-down decision chart (forced go/fg/punt vs policy)")
    pf.add_argument("team_a")
    pf.add_argument("team_b")
    pf.add_argument("--sp", required=True, help="SP+ csv path")
    pf.add_argument("--offense", default="A", type=_arg_offense,
                    help="side with the ball: A or B")
    pf.add_argument("--sec", type=int, default=None,
                    help="seconds remaining in the GAME (overrides "
                         "--quarter/--clock)")
    pf.add_argument("--quarter", type=int, default=4, choices=[1, 2, 3, 4])
    pf.add_argument("--clock", default=None,
                    help="MM:SS remaining in the quarter (default 15:00)")
    pf.add_argument("--dist", type=float, required=True,
                    help="yards to the first-down marker")
    pf.add_argument("--ytg", type=float, required=True,
                    help="yards to the opponent goal line (1-99)")
    pf.add_argument("--score", default="0-0", type=_arg_score,
                    help="current score as A-B, e.g. 21-17")
    pf.add_argument("-n", type=int, default=65536,
                    help="number of GAMES per choice")
    pf.add_argument("--year", type=int, default=2025)
    pf.add_argument("--week", type=int, default=1)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--mode", default="table",
                    choices=["table", "exact", "analytic"])
    pf.add_argument("--quality", default="nano")
    pf.add_argument("--focus", default=None)
    pf.add_argument("--artifacts", default=DEFAULT_ARTIFACT_DIR)
    _add_device(pf)
    pf.set_defaults(fn=_cmd_fourth)

    pp = sub.add_parser(
        "parlay", help="price a same-game parlay off the joint distribution")
    pp.add_argument("team_a")
    pp.add_argument("team_b")
    pp.add_argument("--sp", required=True, help="SP+ csv path")
    pp.add_argument(
        "--legs", required=True,
        help='JSON array of legs, or @path to a JSON file.  Leg kinds: '
             '{"kind":"spread","team":...,"line":-3.5}, '
             '{"kind":"moneyline","team":...}, '
             '{"kind":"total","side":"over|under","line":55.5}, '
             '{"kind":"prop","team":...,"player":...,"stat":"pass_yds",'
             '"side":"over|under","line":249.5}')
    pp.add_argument("-n", type=int, default=32768, help="number of PAIRS")
    pp.add_argument("--price", type=int, default=None,
                    help="quoted American price for the ticket, e.g. +450")
    pp.add_argument("--year", type=int, default=2025)
    pp.add_argument("--week", type=int, default=1)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--mode", default="table",
                    choices=["table", "exact", "analytic"])
    pp.add_argument("--quality", default="nano")
    pp.add_argument("--focus", default=None,
                    help="focus-players csv (needed for prop legs)")
    pp.add_argument("--artifacts", default=DEFAULT_ARTIFACT_DIR)
    pp.add_argument("--shard", action="store_true",
                    help="shard the trial axis over all devices")
    pp.add_argument("--json", action="store_true",
                    help="also print the raw result dict as JSON")
    pp.add_argument("--tease", type=float, default=None,
                    help="price as a teaser: shift every spread/total leg "
                         "this many points in the bettor's favor "
                         "(moneyline/prop legs are refused)")
    pp.add_argument("--corr", action="store_true",
                    help="also print the pairwise leg win-indicator "
                         "correlation matrix (same trial sample)")
    pp.add_argument("--rr", default=None, metavar="K[,K...]",
                    help="also price the round robin: every K-leg "
                         "combination as its own ticket off the same "
                         "trials (e.g. --rr 2 or --rr 2,3)")
    _add_device(pp)
    pp.set_defaults(fn=_cmd_parlay)

    pe = sub.add_parser("edges", help="betting edges over saved sims")
    pe.add_argument("--base", default=None)
    pe.add_argument("--team-a", required=True)
    pe.add_argument("--team-b", required=True)
    pe.add_argument("--spread", type=float, default=None)
    pe.add_argument("--total", type=float, default=None)
    pe.add_argument("--props", default=None)
    pe.add_argument("--dir", default=".")
    pe.add_argument("--device", nargs="?", const="cuda", default=None,
                    help="simulate + reduce in process (no files): bare, on the "
                         "card (raises without one); --device cpu on the CPU")
    pe.add_argument("--sp", default=None, help="SP+ csv (with --device)")
    pe.add_argument("-n", type=int, default=65536,
                    help="pairs (with --device); large market-only scans "
                         "round n UP to whole 32768-pair launches")
    pe.add_argument("--year", type=int, default=2025)
    pe.add_argument("--week", type=int, default=1)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--mode", default="table")
    pe.add_argument("--quality", default="nano")
    pe.add_argument("--focus", default=None)
    pe.add_argument("--shard", action="store_true",
                    help="with --device: shard the trial axis over all "
                         "devices")
    pe.add_argument("--alt", action="store_true",
                    help="print alternate spread/total ladders around the "
                         "quoted lines (same distribution, zero extra sim)")
    pe.add_argument("--alt-width", type=float, default=12.0,
                    help="ladder half-width in points (default 12)")
    pe.add_argument("--alt-step", type=float, default=1.0,
                    help="ladder step in points (default 1)")
    pe.add_argument("--mid-spread", default=None, metavar="TEAM_LINE,OPP_LINE",
                    help="price a spread middle: hold team-a at the first "
                         "line and team-b at the second (negative first "
                         "lines need the = form: --mid-spread=-3.5,7.5)")
    pe.add_argument("--mid-total", default=None, metavar="OVER,UNDER",
                    help="price a total middle: Over the first line and "
                         "Under the second (e.g. 51.5,57.5)")
    pe.add_argument("--artifacts", default=DEFAULT_ARTIFACT_DIR)
    pe.set_defaults(fn=_cmd_edges)

    pr = sub.add_parser(
        "prop", help="price one player prop off saved sims")
    pr.add_argument("team")
    pr.add_argument("player")
    pr.add_argument("stat", help="e.g. pass_yds / rush_yds / rec_yds / INT")
    pr.add_argument("line", type=float)
    pr.add_argument("--base", default=None,
                    help="saved-sim base name (players_<base> table)")
    pr.add_argument("--dir", default=".")
    pr.add_argument("--role", default=None,
                    help="qb/rush/target (default: inferred from the stat)")
    pr.add_argument("--ladder", action="store_true",
                    help="print the alternate-line ladder around the quote "
                         "(same samples, zero extra sim)")
    pr.add_argument("--width", type=float, default=None,
                    help="ladder half-width (default by stat family)")
    pr.add_argument("--step", type=float, default=None,
                    help="ladder step (default by stat family)")
    pr.add_argument("--price", type=int, default=-110)
    pr.set_defaults(fn=_cmd_prop)

    pl = sub.add_parser("slate", help="simulate a slate of matchups")
    pl.add_argument("--games", required=True, help="csv with team_a,team_b columns")
    pl.add_argument("--sp", required=True)
    pl.add_argument("-n", type=int, default=1000)
    pl.add_argument("--year", type=int, default=2025)
    pl.add_argument("--week", type=int, default=1)
    pl.add_argument("--mode", default="table")
    pl.add_argument("--quality", default="nano")
    pl.add_argument("--shard", default="none",
                    choices=["none", "trial", "game"],
                    help="'trial': each matchup's launches split over the "
                         "ranks; 'game': each rank holds a block of the "
                         "matchups' tables and plays them in launches of "
                         "all its matchups (one rank: the whole slate)")
    pl.add_argument("--batched", action="store_true",
                    help="run the whole slate in one launch")
    pl.add_argument("--lines", default=None,
                    help="csv of market lines (team_a[,team_b],spread,"
                         "total; spread from team_a's perspective): prints "
                         "per-matchup spread/total/moneyline edges priced "
                         "off the device summaries (routes the unsharded "
                         "default through the summary sweep)")
    pl.add_argument("--props", default=None,
                    help="prop sheet csv (team,player,stat,yards): scans "
                         "the whole slate's player props with per-matchup "
                         "player-collection sims reduced on the device "
                         "(separate from the score-only slate sims above)")
    pl.add_argument("--props-n", type=int, default=8192, dest="props_n",
                    help="pairs per matchup for the prop sims")
    pl.add_argument("--min-edge", type=float, default=2.0, dest="min_edge",
                    help="min |edge| %% to show a prop (reference: 2)")
    pl.add_argument("--focus", default=None,
                    help="focus players csv for prop rosters")
    pl.add_argument("--artifacts", default=DEFAULT_ARTIFACT_DIR)
    _add_device(pl)
    pl.set_defaults(fn=_cmd_slate)

    pn = sub.add_parser(
        "season", help="season win-total projection (exact Poisson-"
                       "binomial over per-game slate sims)")
    pn.add_argument("team")
    pn.add_argument("--opponents", default=None,
                    help="comma-separated opponent names (team takes "
                         "side A in every matchup)")
    pn.add_argument("--games", default=None,
                    help="csv with team_a,team_b columns; team must "
                         "appear in every row")
    pn.add_argument("--sp", required=True, help="SP+ csv path")
    pn.add_argument("--line", type=float, default=None,
                    help="season win-total quote, e.g. 8.5")
    pn.add_argument("-n", type=int, default=50000, help="PAIRS per matchup")
    pn.add_argument("--year", type=int, default=2025)
    pn.add_argument("--week", type=int, default=1)
    pn.add_argument("--seed", type=int, default=0)
    pn.add_argument("--mode", default="table")
    pn.add_argument("--quality", default="nano")
    pn.add_argument("--artifacts", default=DEFAULT_ARTIFACT_DIR)
    pn.add_argument("--shard", action="store_true",
                    help="shard each matchup's trial axis over the mesh")
    _add_device(pn)
    pn.set_defaults(fn=_cmd_season)

    pk = sub.add_parser(
        "backtest", help="score the sim against actual finals "
                         "(calibration, accuracy, PIT)")
    pk.add_argument("--results", required=True,
                    help="csv of finals: team_a,team_b,score_a,score_b "
                         "(either orientation)")
    pk.add_argument("--games", default=None,
                    help="optional csv of matchups to simulate (default: "
                         "the results rows themselves)")
    pk.add_argument("--sp", required=True,
                    help="SP+ csv AS OF the games' week (pregame ratings "
                         "— postgame ratings would leak the outcomes)")
    pk.add_argument("-n", type=int, default=32768, help="PAIRS per matchup")
    pk.add_argument("--bins", type=int, default=10,
                    help="reliability-table probability bins")
    pk.add_argument("--year", type=int, default=2025)
    pk.add_argument("--week", type=int, default=1)
    pk.add_argument("--seed", type=int, default=0)
    pk.add_argument("--mode", default="table")
    pk.add_argument("--quality", default="nano")
    pk.add_argument("--artifacts", default=DEFAULT_ARTIFACT_DIR)
    pk.add_argument("--shard", action="store_true",
                    help="shard each matchup's trial axis over the mesh")
    _add_device(pk)
    pk.set_defaults(fn=_cmd_backtest)

    pb = sub.add_parser("bench", help="run the benchmark harness")
    pb.add_argument("--mode", default="table")
    pb.add_argument("-n", type=int, default=100000)
    _add_device(pb)
    pb.set_defaults(fn=_cmd_bench)

    pt = sub.add_parser("train", help="train model heads (outside the port's scope)")
    pt.add_argument("--data", required=True, help="ml_*-style plays csv")
    pt.add_argument("--out", required=True, help="artifact output directory")
    pt.add_argument("--heads", default="stage1,stage2,fumble,play",
                    help="comma list: stage1,stage2,fumble,play,pass,run,sack")
    pt.add_argument("--multiclass", action="store_true",
                    help="5-class play model (default binary run/pass)")
    pt.add_argument("--trees", type=int, default=400,
                    help="n_estimators for the quantile heads")
    pt.set_defaults(fn=_cmd_train)

    pv = sub.add_parser(
        "serve", help="resident HTTP service (warm heads/tables/kernels)")
    pv.add_argument("--sp", required=True, help="SP+ csv path")
    pv.add_argument("--artifacts", default=DEFAULT_ARTIFACT_DIR)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8787)
    pv.add_argument("--year", type=int, default=2025)
    pv.add_argument("--week", type=int, default=1)
    pv.add_argument("--mode", default="table")
    pv.add_argument("--quality", default="nano")
    pv.add_argument("--focus", default=None)
    pv.add_argument("--shard", action="store_true",
                    help="default requests to trial-sharded launches")
    pv.add_argument("--warm", default=None,
                    help="games csv to build tables for at startup")
    pv.add_argument("--max-pairs", type=int, default=2_000_000,
                    dest="max_pairs", help="per-request n_pairs ceiling")
    pv.add_argument("--max-games", type=int, default=80, dest="max_games",
                    help="per-request slate size ceiling")
    pv.add_argument("--deadline", type=float, default=None,
                    help="per-request admission deadline (seconds): shed "
                         "requests with 503 when queue wait exceeds it "
                         "(omit or <=0: never shed)")
    pv.add_argument("--aot", default=None, metavar="DIR",
                    help="the JAX CLI's AOT snapshot dir: accepted and "
                         "ignored (eager PyTorch has no program to snapshot)")
    _add_device(pv)
    pv.set_defaults(fn=_cmd_serve)

    args = p.parse_args(argv)
    import torch
    import torch.distributed as dist

    from .parallel.mesh import process_rank

    if ("LOCAL_RANK" in os.environ and getattr(args, "device", None) == "cuda"
            and torch.cuda.is_available()):   # a bare 'cuda' is the rank's own card
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    formed, done = not dist.is_initialized(), False
    try:
        if process_rank() == 0:
            rc = args.fn(args)
        else:   # every rank runs the same calls; only rank 0 prints
            with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
                rc = args.fn(args)
        done = True
        return rc
    finally:
        if formed and dist.is_initialized():   # a group this command formed
            if done:        # every rank done before any tears the group down
                dist.barrier()
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
