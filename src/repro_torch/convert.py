"""Carry a ``StreamState`` across frameworks as nine numpy arrays.

The JAX package has no weights; its ``StreamState`` leaves take their
place.  ``state_to_numpy`` of either package's state (``np.asarray`` of
each leaf) gives a dict that ``state_from_numpy`` installs in the port,
so both engines and appliers can start from one state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.types import StreamState, resolve_device

LEAVES = tuple(f.name for f in dataclasses.fields(StreamState))


def state_from_numpy(arrays: Dict[str, Any],
                     device: Any = None) -> StreamState:
    """A port ``StreamState`` holding copies of the nine arrays, on
    ``device`` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    missing = [n for n in LEAVES if n not in arrays]
    if missing:
        raise KeyError(f"missing state leaves: {missing}")
    return StreamState(**{
        n: torch.tensor(np.array(arrays[n], copy=True), device=device)
        for n in LEAVES})


def state_to_numpy(state: Any) -> Dict[str, np.ndarray]:
    """The nine leaves of a port (or JAX) ``StreamState`` as host arrays."""
    out = {}
    for n in LEAVES:
        leaf = getattr(state, n)
        if isinstance(leaf, torch.Tensor):
            out[n] = leaf.detach().cpu().numpy().copy()
        else:
            out[n] = np.array(leaf, copy=True)
    return out
