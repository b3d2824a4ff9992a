from .embedding import EmbeddingSpec, LabelEmbedding, PackedEmbedding
from .encoders import CrossIntraEncoder, CrossIntraEncoderBlock
from .layers import (Attention, FeedForward, LRLayer, MLPLayer,
                     PreNormAttention, get_activation)
