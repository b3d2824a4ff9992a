from .feature_map import FeatureMap
from .preprocess import Normalizer, Tokenizer, pad_sequences
from .feature_encoder import FeatureEncoder
