from .initializers import embedding_init, xavier_normal
from .embedding import (EmbeddingSpec, LabelEmbedding, MergedEmbeddingLayer,
                        PackedEmbedding)
from .feature_embedding import (FeatureEmbedding, FeatureEmbeddingDict,
                                parse_feature_encoder)
from .layers import (Attention, FeedForward, FMLayer, LRLayer, MLPLayer, PreNorm,
                     PreNormAttention, PreNormFeedForward, Transformer, get_activation)
from .encoders import (CascadeEncoder, CrossIntraEncoder, CrossIntraEncoderBlock,
                       CrossIntraEncoderPA, JointEncoder)
from .interaction import (BilinearInteractionLayer, CompressedInteractionNet, CrossNet,
                          CrossInteractionLayer, HolographicInteractionLayer,
                          InnerProductLayer, InteractionMachine)
from .attention_lib import (DIN_Attention, Dice, MultiHeadTargetAttention,
                            SqueezeExcitationLayer, k_max_pooling,
                            scaled_dot_product_attention)
from .graph import FiGNN_Layer, GraphLayer, HypergraphLayer, PET_Layer
from .deep import APGLinear, APGMLPLayer, MLPBlock
