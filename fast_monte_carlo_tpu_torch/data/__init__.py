from .context import (RoleTable, TeamContext, build_team_context,
                      build_team_context_from_sp_flex, team_context)
from .sp import (load_sp_flex, load_sp_historical, lookup_sp_flex, lookup_sp_historical,
                 norm_team)

__all__ = ["RoleTable", "TeamContext", "team_context", "build_team_context",
           "build_team_context_from_sp_flex", "load_sp_flex", "lookup_sp_flex",
           "load_sp_historical", "lookup_sp_historical", "norm_team"]
