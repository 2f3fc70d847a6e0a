"""Fused neighbour blend + top-n (serving stage B, CUDA kernel).

    pred[q, i] = α·C[uid_q, i] + ((1 − α)·Σ_j C[idx[q, j], i]) / k

then the top-n items per query (ties to the lowest item id), without
writing the [Q, k, I] neighbour gather or the [Q, I] predictions to
device memory.  Replaces
``repro/kernels/serving_topn.py::blend_topn_onehot``: on Hopper the
neighbour sum is a gather of k rows per query, not a one-hot matmul
(see ``csrc/serving_topn.cu``).  Its plain version is
``ref.blend_topn_ref``; ``ops.fused_recommend`` picks between the two.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

MAX_TOPN = 1024   # largest list the merge keeps per query
_BI = 1024        # items per block of csrc/serving_topn.cu


def launch(corpus: torch.Tensor, user_ids: torch.Tensor,
           nbr_idx: torch.Tensor, alpha: float,
           topn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage B: blend and top-n items per query, (f32[Q, n], i32[Q, n]).

    ``corpus`` f32[M, I] × ``user_ids`` int[Q] × ``nbr_idx`` int[Q, k].
    Neighbour entries outside [0, M) (e.g. −1) add 0 but still count in
    k.  Requires ``1 <= topn <= min(I, 1024)``.  Launches the CUDA
    kernels; raises on input they do not take (CPU tensors among them).
    """
    build.cuda_input(corpus, "corpus", (torch.float32,), ndim=2)
    dev = corpus.device
    uid = build.index_input(user_ids, "user_ids", dev, 1)
    nbr = build.index_input(nbr_idx, "nbr_idx", dev, 2)
    m, n_items = corpus.shape
    q_n, k = nbr.shape
    if uid.shape[0] != q_n:
        raise ValueError("user_ids and nbr_idx disagree on Q")
    if not 1 <= topn <= min(n_items, MAX_TOPN):
        raise ValueError(f"topn={topn} outside [1, min(I={n_items}, "
                         f"{MAX_TOPN})]")
    if k < 1:
        raise ValueError("nbr_idx needs at least one neighbour column")
    out_v = torch.empty((q_n, topn), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, topn), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_v, out_i
    n_tiles = -(-n_items // _BI)
    lst = min(topn, _BI)
    n2 = 1 << max(0, (topn - 1).bit_length())
    part_v = torch.empty((q_n, n_tiles, lst), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((q_n, n_tiles, lst), dtype=torch.int32, device=dev)
    build.check(build.library().blend_topn_launch(
        corpus.data_ptr(), uid.data_ptr(), nbr.data_ptr(), q_n, m, n_items,
        k, float(alpha), float(1.0 - alpha), topn, lst, n2,
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), build.stream_of(corpus)), "blend_topn_onehot")
    build.count_launch("blend_topn_onehot")
    return out_v, out_i
