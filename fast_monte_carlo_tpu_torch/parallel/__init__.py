from .aggregate import (ScoreMoments, ScoreSummary, cover_probs, player_stat_probs,
                        score_moments, summarize_scores, summary_from_moments, total_probs)

__all__ = ["ScoreMoments", "ScoreSummary", "score_moments", "summarize_scores",
           "summary_from_moments", "cover_probs", "total_probs", "player_stat_probs"]
