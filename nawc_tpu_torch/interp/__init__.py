from .feature_importance import agg_stats

__all__ = ["agg_stats"]
