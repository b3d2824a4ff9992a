from .bm25 import RetrievalResults, bm25_topk_retrieval
from .similarity import jaccard_similarity, map_indices
