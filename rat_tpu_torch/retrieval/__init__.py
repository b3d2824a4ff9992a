from .bm25 import RetrievalResults, bm25_topk_retrieval
