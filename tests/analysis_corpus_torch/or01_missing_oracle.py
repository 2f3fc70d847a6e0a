# ruff: noqa
"""Corpus case: dispatcher with no plain version (expected OR01).

A public dispatcher that never consults `ref.*` has no ground truth:
nothing can catch its kernel silently drifting.
"""
from repro_torch.kernels import knn_topk as _knn


def thing(queries, corpus, k, impl=None):
    return _knn.launch(queries, corpus, k)
