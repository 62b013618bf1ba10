"""Box-score formatting over the engine's team-stat arrays: a copy of
fast_monte_carlo_tpu/boxscore.py (numpy only)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .stats import TS


def format_team_line(team: str, s: np.ndarray) -> str:
    pts = int(s[TS["points"]])
    att = int(s[TS["pass_att"]])
    comp = int(s[TS["comp"]])
    pass_yds = float(s[TS["pass_yds"]])
    cmp_pct = 100.0 * comp / att if att else 0.0
    ypa = pass_yds / att if att else 0.0
    rush_att = int(s[TS["rush_att"]])
    rush_yds = float(s[TS["rush_yds"]])
    ypc = rush_yds / rush_att if rush_att else 0.0
    return (
        f"{team}: {pts} pts | "
        f"Pass {comp}/{att} ({cmp_pct:.0f}%) for {pass_yds:.1f} yds (YPA {ypa:.1f}), "
        f"TD {int(s[TS['pass_td']])}, INT {int(s[TS['INT']])}, Sacks {int(s[TS['sacks']])} | "
        f"Rush {rush_att} for {rush_yds:.1f} yds (YPC {ypc:.1f}), TD {int(s[TS['rush_td']])} | "
        f"FG {int(s[TS['FG']])}/{int(s[TS['FGA']])}, Punts {int(s[TS['punts']])} | "
        f"RZ {int(s[TS['rz_TD']])}/{int(s[TS['rz_trips']])} TD | "
        f"4th {int(s[TS['fourth_conv']])}/{int(s[TS['fourth_go']])}"
    )


def format_boxscore(team_names: Sequence[str], stats_pair: np.ndarray) -> str:
    """stats_pair: (2, N_TEAM_STATS) for one game."""
    return "\n".join(format_team_line(t, stats_pair[i])
                     for i, t in enumerate(team_names))


def print_boxscore(team_names, stats_pair) -> None:
    print(format_boxscore(team_names, np.asarray(stats_pair)))


def mean_boxscore(team_names, stats: np.ndarray) -> str:
    """Average box score over a batch: stats (B, 2, N)."""
    return format_boxscore(team_names, np.asarray(stats).mean(axis=0))
