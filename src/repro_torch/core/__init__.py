"""Core: the paper's contribution — TIFU-kNN maintenance under additions
and deletions of baskets and items (Wang & Schelter, ORSUM@RecSys'21),
in PyTorch.  The public names of the JAX package's ``repro.core`` but
its numpy oracle engine."""
from repro_torch.core.types import (PAD_ID, KIND_NOOP, KIND_ADD_BASKET,
                                    KIND_DEL_BASKET, KIND_DEL_ITEM,
                                    PAPER_HYPERPARAMS, AddBatch,
                                    DelBasketBatch, DelItemBatch,
                                    RaggedUserState, StreamState,
                                    TifuParams, UpdateBatch)
from repro_torch.core import decay, knn, stability, tifu
from repro_torch.core.updates import (SCALE_CEIL, SCALE_FLOOR,
                                      apply_add_batch,
                                      apply_del_basket_batch,
                                      apply_del_basket_batch_dense,
                                      apply_del_item_batch,
                                      apply_del_item_batch_dense,
                                      apply_update_batch,
                                      apply_update_batch_dense,
                                      refresh_users, renormalize_users)

__all__ = [
    "PAD_ID", "KIND_NOOP", "KIND_ADD_BASKET", "KIND_DEL_BASKET",
    "KIND_DEL_ITEM", "PAPER_HYPERPARAMS", "AddBatch", "DelBasketBatch",
    "DelItemBatch", "RaggedUserState", "StreamState", "TifuParams",
    "UpdateBatch", "decay", "knn", "stability", "tifu",
    "SCALE_CEIL", "SCALE_FLOOR", "apply_add_batch",
    "apply_del_basket_batch", "apply_del_basket_batch_dense",
    "apply_del_item_batch", "apply_del_item_batch_dense",
    "apply_update_batch", "apply_update_batch_dense",
    "refresh_users", "renormalize_users",
]
