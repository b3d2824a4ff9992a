"""Hand-written Hopper kernels (sources in rat_tpu_torch/csrc/), each
beside its plain PyTorch version:

- K1 ``cross_intra_block``: one fused RAT_m2 encoder block;
- K2 ``bm25_topk``: fused BM25 score + top-K over the pool.
"""
