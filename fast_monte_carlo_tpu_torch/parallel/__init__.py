from .aggregate import (ScoreMoments, ScoreSummary, cover_probs, player_stat_probs,
                        score_moments, summarize_scores, summary_from_moments, total_probs)
from .mesh import (TrialGroup, game_group, simulate_games_sharded, simulate_moments_sharded,
                   trial_group)

__all__ = ["ScoreMoments", "ScoreSummary", "score_moments", "summarize_scores",
           "summary_from_moments", "cover_probs", "total_probs", "player_stat_probs",
           "TrialGroup", "trial_group", "game_group", "simulate_games_sharded",
           "simulate_moments_sharded"]
