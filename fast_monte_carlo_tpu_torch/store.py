"""Content-addressed sim bundles: port of fast_monte_carlo_tpu/store.py.

A bundle is a run directory holding games.parquet, players.parquet (if
given) and meta.json; its signature is the sha256 of the meta's canonical
JSON, so an analysis can name exactly the run it read.  `make_signature`
is plain `json` + `hashlib` and gives the JAX package's hex for the same
meta; the bundles are the JAX package's files, so either package reads
what the other wrote.  Parquet goes through pandas, imported on use.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional, Tuple

GAMES_KEEP = ["sim_id", "team", "opp", "pts", "opp_pts", "margin", "total", "seed"]


def make_signature(meta: dict) -> str:
    """sha256 over the canonical JSON form of the meta dict.

    The canonical form (sorted keys, no whitespace) must never change: it
    is the content address, and bundles written under one form would not
    round-trip under another."""
    canonical = json.dumps(meta, sort_keys=True, separators=(",", ":"))
    digest = hashlib.sha256(canonical.encode("utf-8"))
    return digest.hexdigest()


def save_sim_bundle(run_dir, games, players, meta: dict) -> str:
    """Write a bundle; returns its signature.  `games` and `players` are
    DataFrames or dicts of columns (e.g. `api.scores_columns`); games keep
    GAMES_KEEP, margin and total computed where absent, other missing
    columns 0."""
    import pandas as pd

    p = Path(run_dir)
    p.mkdir(parents=True, exist_ok=True)
    g = games.copy() if isinstance(games, pd.DataFrame) else pd.DataFrame(games)
    if "margin" not in g:
        g["margin"] = g.pts - g.opp_pts
    if "total" not in g:
        g["total"] = g.pts + g.opp_pts
    for col in GAMES_KEEP:
        if col not in g:
            g[col] = 0
    g[GAMES_KEEP].to_parquet(p / "games.parquet", index=False)
    if players is not None:
        pl = players if isinstance(players, pd.DataFrame) else pd.DataFrame(players)
        pl.to_parquet(p / "players.parquet", index=False)
    sig = make_signature(meta)
    meta = dict(meta, signature=sig)
    (p / "meta.json").write_text(json.dumps(meta, indent=2))
    return sig


def load_sim_bundle(run_dir) -> Tuple[object, Optional[object], dict]:
    """(games DataFrame, players DataFrame or None, meta) of a bundle."""
    import pandas as pd

    p = Path(run_dir)
    games = pd.read_parquet(p / "games.parquet")
    players_path = p / "players.parquet"
    players = pd.read_parquet(players_path) if players_path.exists() else None
    meta = json.loads((p / "meta.json").read_text())
    return games, players, meta
