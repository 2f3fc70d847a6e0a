"""Core datatypes for the TIFU-kNN maintenance system (PyTorch port).

``RaggedUserState`` is the paper-faithful per-user state (ragged numpy,
float64), the state of the paper's §4.3 algorithms.  ``StreamState`` is
the padded struct-of-tensors state for ``M`` users; its two vector
tables are stored *scaled* (true = raw × per-user scale) so basket
additions apply sparse deltas.  ``UpdateBatch`` carries a mixed
micro-batch (adds and deletes in one fixed shape); ``AddBatch`` /
``DelBasketBatch`` / ``DelItemBatch`` carry one homogeneous micro-batch
each, and their ``build`` methods pad on the host exactly as the JAX
package does and place the result on ``device``.  Like every entry
point of the port, ``StreamState.zeros``, ``UpdateBatch.noop`` and the
``build`` methods run on the CUDA device unless the caller passes
another, and raise when there is no card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

PAD_ID = -1  # padding value for item ids in basket arrays


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and no
    card is present -- there is no quiet move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return dev


def make_user_shard_devices(n_shards: int,
                            devices: Optional[Sequence[Any]] = None
                            ) -> List[torch.device]:
    """One device per user shard, dealt round-robin.

    Shard ``s`` gets ``devices[s % len(devices)]``: with at least as many
    devices as shards each shard has its own, with fewer they share them,
    so on one H100 every shard gets ``cuda:0``.  ``devices`` defaults to every
    visible CUDA device and raises when there is none: pass
    ``devices=["cpu"]`` to run the shards on the CPU.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to "
                               "run the shards on the CPU")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("devices is empty")
    return [devices[s % len(devices)] for s in range(n_shards)]


@dataclasses.dataclass(frozen=True)
class TifuParams:
    """TIFU-kNN hyper-parameters (Table 1 of the paper).

    Attributes:
      n_items: vocabulary size ``|I|``.
      group_size: nominal group size ``m``.
      r_b: within-group (basket) time-decay rate, ``0 < r_b <= 1``.
      r_g: across-group time-decay rate, ``0 < r_g <= 1``.
      k_neighbors: number of nearest neighbours for the CF component.
      alpha: weight of the personal component in the final prediction.
    """

    n_items: int
    group_size: int = 7
    r_b: float = 0.9
    r_g: float = 0.7
    k_neighbors: int = 300
    alpha: float = 0.7

    def __post_init__(self) -> None:
        if not (0.0 < self.r_b <= 1.0):
            raise ValueError(f"r_b must be in (0, 1], got {self.r_b}")
        if not (0.0 < self.r_g <= 1.0):
            raise ValueError(f"r_g must be in (0, 1], got {self.r_g}")
        if self.group_size < 1:
            raise ValueError("group_size must be >= 1")


# Hyper-parameters used in the paper's experiments (Table 1):
#   [m, r_b, r_g, k, alpha]
PAPER_HYPERPARAMS = {
    "tafeng": TifuParams(n_items=11997, group_size=7, r_b=0.9, r_g=0.7,
                         k_neighbors=300, alpha=0.7),
    "instacart": TifuParams(n_items=7999, group_size=3, r_b=0.9, r_g=0.7,
                            k_neighbors=900, alpha=0.9),
    "valuedshopper": TifuParams(n_items=7874, group_size=7, r_b=1.0, r_g=0.6,
                                k_neighbors=300, alpha=0.7),
}


@dataclasses.dataclass
class RaggedUserState:
    """Paper-faithful per-user state (ragged, numpy, float64).

    ``history`` is a list of baskets, each a 1-D int array of item ids;
    ``group_sizes[j]`` is the number of baskets in group ``j`` under the
    varying group size relaxation (paper §4.3); ``user_vec`` and
    ``last_group_vec`` are dense ``|I|`` vectors; ``err_mult`` is the
    worst-case multiplicative error factor of the decremental updates
    applied so far (``core.stability``).
    """

    history: List[np.ndarray]
    group_sizes: List[int]
    user_vec: np.ndarray
    last_group_vec: np.ndarray
    err_mult: float = 1.0

    @property
    def n_baskets(self) -> int:
        return len(self.history)

    @property
    def n_groups(self) -> int:
        return len(self.group_sizes)

    @staticmethod
    def empty(n_items: int) -> "RaggedUserState":
        return RaggedUserState(
            history=[],
            group_sizes=[],
            user_vec=np.zeros(n_items, dtype=np.float64),
            last_group_vec=np.zeros(n_items, dtype=np.float64),
        )


@dataclasses.dataclass
class StreamState:
    """Padded struct-of-tensors state for ``M`` users.

    Shapes (``M`` users, ``N`` max baskets, ``B`` max basket size,
    ``K`` max groups, ``I`` items):

      user_vecs:       f32[M, I]   raw (scaled) storage
      last_group_vecs: f32[M, I]   raw (scaled) storage
      history:         i32[M, N, B]   (PAD_ID padded)
      group_sizes:     i32[M, K]
      n_baskets:       i32[M]
      n_groups:        i32[M]
      err_mult:        f32[M]
      uv_scale:        f32[M]
      lgv_scale:       f32[M]

    The true vectors are ``uv_scale[u] * user_vecs[u]`` and
    ``lgv_scale[u] * last_group_vecs[u]``; use the ``materialized_*``
    accessors for serving and comparisons.  The appliers in
    ``core.updates`` update these tensors in place.
    """

    user_vecs: torch.Tensor
    last_group_vecs: torch.Tensor
    history: torch.Tensor
    group_sizes: torch.Tensor
    n_baskets: torch.Tensor
    n_groups: torch.Tensor
    err_mult: torch.Tensor
    uv_scale: torch.Tensor
    lgv_scale: torch.Tensor

    def materialized_user_vecs(self) -> torch.Tensor:
        """True user vectors f32[M, I] (raw rows × per-user scale)."""
        return self.user_vecs * self.uv_scale[:, None]

    def materialized_last_group_vecs(self) -> torch.Tensor:
        """True last-group vectors f32[M, I]."""
        return self.last_group_vecs * self.lgv_scale[:, None]

    @property
    def device(self) -> torch.device:
        return self.user_vecs.device

    @property
    def n_users(self) -> int:
        return self.user_vecs.shape[0]

    @property
    def n_items(self) -> int:
        return self.user_vecs.shape[1]

    @property
    def max_baskets(self) -> int:
        return self.history.shape[1]

    @property
    def max_basket_size(self) -> int:
        return self.history.shape[2]

    @property
    def max_groups(self) -> int:
        return self.group_sizes.shape[1]

    @staticmethod
    def zeros(n_users: int, n_items: int, max_baskets: int,
              max_basket_size: int, max_groups: int | None = None,
              dtype: torch.dtype = torch.float32,
              device: Any = None) -> "StreamState":
        """An empty state on ``device`` (CUDA unless the caller names
        another; raises without a card)."""
        device = resolve_device(device)
        if max_groups is None:
            max_groups = max_baskets  # worst case: all groups of size 1
        i32 = dict(dtype=torch.int32, device=device)
        return StreamState(
            user_vecs=torch.zeros((n_users, n_items), dtype=dtype,
                                  device=device),
            last_group_vecs=torch.zeros((n_users, n_items), dtype=dtype,
                                        device=device),
            history=torch.full((n_users, max_baskets, max_basket_size),
                               PAD_ID, **i32),
            group_sizes=torch.zeros((n_users, max_groups), **i32),
            n_baskets=torch.zeros((n_users,), **i32),
            n_groups=torch.zeros((n_users,), **i32),
            err_mult=torch.ones((n_users,), dtype=dtype, device=device),
            uv_scale=torch.ones((n_users,), dtype=dtype, device=device),
            lgv_scale=torch.ones((n_users,), dtype=dtype, device=device),
        )


# Update kinds for the streaming engine (Algorithm 1 generalised).
KIND_NOOP = 0
KIND_ADD_BASKET = 1
KIND_DEL_BASKET = 2
KIND_DEL_ITEM = 3


@dataclasses.dataclass
class UpdateBatch:
    """A fixed-shape micro-batch of updates (adds and deletes mixed).

    kind:         i32[U]    one of KIND_*
    user:         i32[U]    target user row
    basket_items: i32[U, B] item ids for adds (PAD_ID padded)
    basket_pos:   i32[U]    global basket index for deletions
    item:         i32[U]    item id for item deletions
    """

    kind: torch.Tensor
    user: torch.Tensor
    basket_items: torch.Tensor
    basket_pos: torch.Tensor
    item: torch.Tensor

    @property
    def size(self) -> int:
        return self.kind.shape[0]

    @staticmethod
    def noop(batch: int, max_basket_size: int,
             device: Any = None) -> "UpdateBatch":
        """``batch`` rows of KIND_NOOP on ``device`` (CUDA unless the
        caller names another; raises without a card)."""
        i32 = dict(dtype=torch.int32, device=resolve_device(device))
        return UpdateBatch(
            kind=torch.zeros((batch,), **i32),
            user=torch.zeros((batch,), **i32),
            basket_items=torch.full((batch, max_basket_size), PAD_ID, **i32),
            basket_pos=torch.zeros((batch,), **i32),
            item=torch.full((batch,), PAD_ID, **i32),
        )


# ---------------------------------------------------------------------------
# Kind-partitioned homogeneous sub-batches
# ---------------------------------------------------------------------------
#
# Rows beyond the real event count have valid=False and zero effect; they
# carry user 0 and so may alias a valid row of user 0.  Every state write
# of the appliers is therefore an accumulating delta (index_put_ with
# accumulate=True, or a product scatter with factor 1), never a plain set.

def _pow2_pad(n: int, cap: int = 0) -> int:
    """Pad a sub-batch length to the next power of two, capped by
    ``cap`` (the engine batch size; 0 means uncapped)."""
    if n <= 0:
        return 1
    p = 1 << (n - 1).bit_length()
    return min(p, max(cap, n)) if cap else p


def _resolve_pad(n: int, pad_cap: int, pad_to: int) -> int:
    """Padded row count for a sub-batch build: an explicit ``pad_to``
    (the engine's hysteresis-held bucket) wins over the pow2 default."""
    if pad_to:
        if pad_to < n:
            raise ValueError(f"pad_to={pad_to} < sub-batch size {n}")
        return pad_to
    return _pow2_pad(n, pad_cap)


def _dev(x: np.ndarray, device: Any) -> torch.Tensor:
    return torch.from_numpy(x).to(resolve_device(device))


@dataclasses.dataclass
class AddBatch:
    """Homogeneous basket-addition sub-batch.

    user:  i32[U]     target user row
    items: i32[U, B]  item ids of the new basket (PAD_ID padded)
    valid: bool[U]    False for padding rows (zero effect)
    """

    user: torch.Tensor
    items: torch.Tensor
    valid: torch.Tensor

    @property
    def size(self) -> int:
        return self.user.shape[0]

    @staticmethod
    def build(users: Sequence[int], baskets: Sequence[Any],
              max_basket_size: int, pad_cap: int = 0, pad_to: int = 0,
              device: Any = None) -> "AddBatch":
        """From parallel host lists of user ids and item-id sequences.

        Baskets are item sets: ids are deduplicated and PADs dropped."""
        n = len(users)
        u = _resolve_pad(n, pad_cap, pad_to)
        user = np.zeros(u, np.int32)
        items = np.full((u, max_basket_size), PAD_ID, np.int32)
        valid = np.zeros(u, bool)
        for r, (uu, b) in enumerate(zip(users, baskets)):
            user[r] = uu
            ids = np.unique(np.asarray(b, np.int32))
            ids = ids[ids >= 0][:max_basket_size]
            items[r, :len(ids)] = ids
            valid[r] = True
        return AddBatch(user=_dev(user, device), items=_dev(items, device),
                        valid=_dev(valid, device))


@dataclasses.dataclass
class DelBasketBatch:
    """Homogeneous basket-deletion sub-batch.

    user: i32[U]   target user row
    pos:  i32[U]   global basket index to delete
    valid: bool[U]
    """

    user: torch.Tensor
    pos: torch.Tensor
    valid: torch.Tensor

    @property
    def size(self) -> int:
        return self.user.shape[0]

    @staticmethod
    def build(users: Sequence[int], positions: Sequence[int],
              pad_cap: int = 0, pad_to: int = 0,
              device: Any = None) -> "DelBasketBatch":
        n = len(users)
        u = _resolve_pad(n, pad_cap, pad_to)
        user = np.zeros(u, np.int32)
        pos = np.zeros(u, np.int32)
        valid = np.zeros(u, bool)
        user[:n] = np.asarray(users, np.int32)
        pos[:n] = np.asarray(positions, np.int32)
        valid[:n] = True
        return DelBasketBatch(user=_dev(user, device), pos=_dev(pos, device),
                              valid=_dev(valid, device))


@dataclasses.dataclass
class DelItemBatch:
    """Homogeneous item-deletion sub-batch (Eq. 13 with vanish fallback).

    user: i32[U]   target user row
    pos:  i32[U]   global basket index holding the item
    item: i32[U]   item id to delete
    valid: bool[U]
    """

    user: torch.Tensor
    pos: torch.Tensor
    item: torch.Tensor
    valid: torch.Tensor

    @property
    def size(self) -> int:
        return self.user.shape[0]

    @staticmethod
    def build(users: Sequence[int], positions: Sequence[int],
              items: Sequence[int], pad_cap: int = 0, pad_to: int = 0,
              device: Any = None) -> "DelItemBatch":
        n = len(users)
        u = _resolve_pad(n, pad_cap, pad_to)
        user = np.zeros(u, np.int32)
        pos = np.zeros(u, np.int32)
        item = np.full(u, PAD_ID, np.int32)
        valid = np.zeros(u, bool)
        user[:n] = np.asarray(users, np.int32)
        pos[:n] = np.asarray(positions, np.int32)
        item[:n] = np.asarray(items, np.int32)
        valid[:n] = True
        return DelItemBatch(user=_dev(user, device), pos=_dev(pos, device),
                            item=_dev(item, device),
                            valid=_dev(valid, device))
