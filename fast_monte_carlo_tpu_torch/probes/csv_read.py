"""Host time of a saved players file: its write and its read, both splitters.

`sim --players --save` writes `players_<base>` with `api._write_columns_csv`,
and `edges`/`prop` read it back with `data.columns.read_csv_columns`, which
cuts the fields by numpy's C reader (`_byte_fields`) where the file allows
and by the `csv` module (`_csv_fields`) otherwise; both feed the same
typing (`text_column`).  This probe plays the focus-roster fixture matchup
in table mode with player rows, writes that file, and times the write and
each splitter's read, in turns, checking that both reads give the same
columns bit for bit.

    python -m fast_monte_carlo_tpu_torch.probes.csv_read [--pairs 16384]
        [--reps 3] [--device cuda|cpu]

The default is the game count of `chip_smoke.py` phase 15's `sim --save`
(16,384 pairs).  Times are host seconds (`time.perf_counter`); the card
only plays the games.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from .. import api, fixtures, resolve_device
from ..config import SimConfig
from ..data import columns


def _same(got: dict, want: dict) -> bool:
    if list(got) != list(want):
        return False
    for k in want:
        g, w = got[k], want[k]
        if g.dtype != w.dtype:
            return False
        if w.dtype.kind in "fiub":
            if not np.array_equal(g.view(np.uint8), w.view(np.uint8)):
                return False
        elif not all(x == y or (x != x and y != y) for x, y in zip(g, w)):
            return False
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=16_384)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0])

    a, b = fixtures.focus_teams(3)
    runner = api.MatchupRunner(a, b, None, SimConfig(), "table",
                               nano_tables=fixtures.nano_tables(7), device=dev)
    out = runner.run_pairs(args.pairs, seed=5, collect_players=True)
    players = api.players_columns(out, a, b)
    rows = len(next(iter(players.values())))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "players.csv")
        t0 = time.perf_counter()
        api._write_columns_csv(path, players)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if columns._byte_fields(f.read()) is None:
                print("csv_read: numpy's C reader refused the file", file=sys.stderr)
                return 1
        ways = {"numpy": columns.read_csv_columns, "csv": _read_by_csv}
        times = {k: [] for k in ways}
        got = {}
        for _ in range(args.reps):
            for k, read in ways.items():
                t0 = time.perf_counter()
                got[k] = read(path)
                times[k].append(time.perf_counter() - t0)
        if not _same(got["csv"], got["numpy"]):
            print("csv_read: the two splitters disagree", file=sys.stderr)
            return 1
    print(f"{rows:,} player rows from {2 * args.pairs:,} games, {size:,} bytes; "
          f"write {write_s:.3f} s")
    for k, ts in times.items():
        print(f"read, {k} splitter: " + " ".join(f"{t:.3f}" for t in ts)
              + f" s (best {min(ts):.3f})")
    return 0


def _read_by_csv(path) -> dict:
    """`read_csv_columns` with the fields cut by the `csv` module."""
    names, cells = columns._csv_fields(path)
    return {k: columns.text_column(v) for k, v in zip(columns._mangled(names), cells)}


if __name__ == "__main__":
    sys.exit(main())
