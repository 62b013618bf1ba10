from .forest import FlatForest, FeatureLayout
from .xgb_json import forest_from_xgb_json, load_xgb_json, forest_from_xgb_raw
from .sklearn_gbr import forest_from_gbr_pipeline, load_gbr_forest

__all__ = [
    "FlatForest", "FeatureLayout",
    "forest_from_xgb_json", "load_xgb_json", "forest_from_xgb_raw",
    "forest_from_gbr_pipeline", "load_gbr_forest",
]
