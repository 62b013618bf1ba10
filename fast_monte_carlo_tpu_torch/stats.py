"""Stat-array layouts: a copy of fast_monte_carlo_tpu/stats.py.

Team stats are (B, 2, N_TEAM_STATS) in TEAM_STAT_FIELDS order; player stats
are (B, 2, 3, K, N_PLAYER_STATS): side, role, slot and the unified 6-column
layout below.
"""
from __future__ import annotations

TEAM_STAT_FIELDS = (
    "plays", "pass_att", "comp", "pass_yds", "pass_td", "INT", "sacks",
    "rush_att", "rush_yds", "rush_td", "FG", "FGA", "punts",
    "rz_trips", "rz_TD", "fourth_go", "fourth_conv", "points",
    "fumbles_lost",  # extension head (trained-but-unwired in the reference)
)
TS = {name: i for i, name in enumerate(TEAM_STAT_FIELDS)}
N_TEAM_STATS = len(TEAM_STAT_FIELDS)

# player roles and the unified 6-column stat layout
ROLE_PASS, ROLE_RUSH, ROLE_REC = 0, 1, 2
ROLES = ("pass", "rush", "rec")
# column meaning by role:
#   pass: att comp yds td INT sacks
#   rush: att  --  yds td  --   --
#   rec : tgt rec  yds td  --   --
PC_ATT, PC_COMP, PC_YDS, PC_TD, PC_INT, PC_SACKS = range(6)
N_PLAYER_STATS = 6

PLAYER_COLS = (
    "sim", "start", "team", "opp", "player", "role",
    "pass_att", "pass_comp", "pass_yds", "pass_td", "INT", "sacks",
    "rush_att", "rush_yds", "rush_td",
    "rec", "tgt", "rec_yds", "rec_td",
)

ROLE_LABEL = {ROLE_PASS: "QB", ROLE_RUSH: "Rusher", ROLE_REC: "Receiver"}
