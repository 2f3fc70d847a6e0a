"""Carry state and weights across frameworks as numpy arrays.

The TIFU-kNN system has no weights; its ``StreamState`` leaves take
their place.  ``state_to_numpy`` of either package's state
(``np.asarray`` of each leaf) gives a dict that ``state_from_numpy``
installs in the port, so both engines and appliers can start from one
state.  ``transformer_params_from_numpy`` does the same for the LM
stack's parameter tree, ``recsys_params_from_numpy`` for the four
recommender models' and DimeNet's.  ``opt_state_from_numpy`` and
``opt_state_to_numpy`` carry a JAX ``OptState`` (AdamW's ``m`` / ``v``,
Adafactor's ``v`` or ``vr`` / ``vc``, SGD's momentum, and the step) to
and from the port's optimizer over such a model, leaf by leaf by
parameter name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.types import StreamState, resolve_device
from repro_torch.models import bert4rec, deepfm, dimenet, dlrm, two_tower
from repro_torch.models.transformer import (Transformer, TransformerConfig,
                                            param_shapes)
from repro_torch.optim.optimizers import (SGD, Adafactor, AdamW,
                                          ClippedOptimizer, OptState)

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


def transformer_params_from_numpy(params: Dict[str, Any],
                                  c: TransformerConfig,
                                  device: Any = None) -> Transformer:
    """The port's model holding the JAX parameter tree ``params``
    (numpy leaves: ``embed``, ``final_ln``, ``unembed`` when untied,
    ``mtp_proj`` / ``mtp_ln`` with the MTP head, and the ``dense_layers``
    and ``moe_layers`` groups stacked ``[L, ...]``, GQA or MLA), cast to
    ``c.dtype``, on ``device`` (CUDA unless the caller names another).
    A leaf of the wrong shape raises, naming it."""
    shapes = param_shapes(c)
    model = Transformer(c, device)

    def put(dst: torch.Tensor, src: Any, shape: tuple, name: str) -> None:
        src = np.asarray(src)
        if src.shape != shape:
            raise ValueError(f"{name}: shape {src.shape}, expected {shape}")
        dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))

    groups = {name: layers for name, layers, _ in model.groups()}
    for name, shape in shapes.items():
        if not isinstance(shape, dict):
            put(getattr(model, name), params[name], shape, name)
            continue
        layers = groups[name.split("_")[0]]
        for leaf, stacked in shape.items():
            src = np.asarray(params[name][leaf])
            if src.shape[:1] != stacked[:1]:
                raise ValueError(f"{name}.{leaf}: shape {src.shape}, "
                                 f"expected {stacked}")
            for i, layer in enumerate(layers):
                put(getattr(layer, leaf), src[i], stacked[1:],
                    f"{name}.{leaf}[{i}]")
    return model


# the port's model class of each recommender architecture (and DimeNet)
RECSYS_MODELS = {"two_tower": two_tower.TwoTower, "dlrm": dlrm.DLRM,
                 "deepfm": deepfm.DeepFM, "bert4rec": bert4rec.Bert4Rec,
                 "dimenet": dimenet.DimeNet}


def _jax_leaf(tree: Dict[str, Any], name: str) -> Any:
    """The leaf of a JAX recommender tree that port parameter ``name``
    holds: ``mlp.w.3`` is ``tree["mlp"][3]["w"]``, ``blocks.wq`` is
    ``tree["blocks"]["wq"]``."""
    parts = name.split(".")
    if len(parts) == 3 and parts[1] in ("w", "b"):
        return tree[parts[0]][int(parts[2])][parts[1]]
    node = tree
    for p in parts:
        node = node[p]
    return node


def _n_leaves(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_n_leaves(v) for v in tree)
    return 1


def recsys_params_from_numpy(arch: str, params: Dict[str, Any], c: Any,
                             device: Any = None) -> Any:
    """The port's ``arch`` model (``two_tower``, ``dlrm``, ``deepfm``,
    ``bert4rec`` or ``dimenet``) holding the JAX parameter tree
    ``params`` (numpy leaves: tables, each MLP a list of ``{"w", "b"}``,
    BERT4Rec's and DimeNet's ``blocks`` stacked ``[L, ...]``), cast to
    ``c.dtype``, on ``device`` (CUDA unless the caller names
    another)."""
    model = RECSYS_MODELS[arch](c, device)
    n_ours = len(list(model.parameters()))
    if _n_leaves(params) != n_ours:
        raise ValueError(f"{arch}: {_n_leaves(params)} leaves, the port's "
                         f"model holds {n_ours}")
    for name, p in model.named_parameters():
        src = np.asarray(_jax_leaf(params, name))
        if src.shape != tuple(p.shape):
            raise ValueError(f"{arch}.{name}: shape {src.shape}, expected "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
    return model


def _set_jax_leaf(tree: Dict[str, Any], name: str, value: Any) -> None:
    """Put ``value`` where :func:`_jax_leaf` reads port parameter
    ``name`` (MLP layers in a list, in order)."""
    parts = name.split(".")
    if len(parts) == 3 and parts[1] in ("w", "b"):
        layers: List[Dict[str, Any]] = tree.setdefault(parts[0], [])
        i = int(parts[2])
        layers.extend({} for _ in range(i + 1 - len(layers)))
        layers[i][parts[1]] = value
        return
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def _named_state(optimizer: ClippedOptimizer, model: torch.nn.Module):
    """(name, state dict) of each of ``model``'s parameters."""
    for name, p in model.named_parameters():
        if p not in optimizer.state:
            raise KeyError(f"{name} is not one of the optimizer's "
                           f"parameters")
        yield name, optimizer.state[p]


def opt_state_from_numpy(optimizer: ClippedOptimizer,
                         model: torch.nn.Module, state: Any) -> None:
    """Install a JAX ``OptState`` (``jax.tree.map(np.asarray, ...)`` of
    one, or a port :class:`OptState`) in ``optimizer``, the port's
    optimizer over ``model``: the step count and every leaf's state,
    matched by parameter name, copied IN PLACE."""
    step, inner = state
    # JAX's inner tree: AdamW's {"m": tree, "v": tree}, SGD's the
    # momentum tree, Adafactor's a tree of {"v"} or {"vr", "vc"} dicts
    for name, st in _named_state(optimizer, model):
        if isinstance(optimizer, AdamW):
            src = {k: _jax_leaf(inner[k], name) for k in ("m", "v")}
        elif isinstance(optimizer, SGD):
            src = {"m": _jax_leaf(inner, name)}
        else:
            src = _jax_leaf(inner, name)
        if set(src) != set(st):
            raise ValueError(f"{name}: state {sorted(src)}, the port's "
                             f"optimizer holds {sorted(st)}")
        for k, dst in st.items():
            arr = np.asarray(src[k])
            if arr.shape != tuple(dst.shape):
                raise ValueError(f"{name}.{k}: shape {arr.shape}, "
                                 f"expected {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    optimizer.n_steps = int(np.asarray(step))


def opt_state_to_numpy(optimizer: ClippedOptimizer,
                       model: torch.nn.Module) -> OptState:
    """``optimizer``'s state as the JAX ``OptState`` tree: ``step`` an
    int32 scalar, ``inner`` numpy leaves laid out as the reference's
    optimizer over ``model``'s parameter tree lays them out."""
    inner: Dict[str, Any] = {}
    for name, st in _named_state(optimizer, model):
        host = {k: v.detach().cpu().numpy().copy() for k, v in st.items()}
        if isinstance(optimizer, AdamW):
            for k in ("m", "v"):
                _set_jax_leaf(inner.setdefault(k, {}), name, host[k])
        elif isinstance(optimizer, SGD):
            _set_jax_leaf(inner, name, host["m"])
        elif isinstance(optimizer, Adafactor):
            _set_jax_leaf(inner, name, host)
    return OptState(step=np.asarray(optimizer.n_steps, np.int32),
                    inner=inner)
