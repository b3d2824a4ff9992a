from .feature_map import FeatureMap
