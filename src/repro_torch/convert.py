"""Carry state and weights across frameworks as numpy arrays.

The TIFU-kNN system has no weights; its ``StreamState`` leaves take
their place.  ``state_to_numpy`` of either package's state
(``np.asarray`` of each leaf) gives a dict that ``state_from_numpy``
installs in the port, so both engines and appliers can start from one
state.  ``transformer_params_from_numpy`` does the same for the LM
stack's parameter tree (``transformer_params_to_numpy`` back, and
``transformer_params_tree`` / ``load_transformer_params`` with host
tensors, for the training driver's checkpoints),
``recsys_params_from_numpy`` for the four recommender models' and
DimeNet's.  ``opt_state_from_numpy`` and ``opt_state_to_numpy`` carry a
JAX ``OptState`` (AdamW's ``m`` / ``v``, Adafactor's ``v`` or ``vr`` /
``vc``, SGD's momentum, and the step) to and from the port's optimizer
over such a model, leaf by leaf by parameter name (an LM's layers
stacked per group; ``lm_opt_state_tree`` gives it as host tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.types import StreamState, resolve_device
from repro_torch.models import bert4rec, deepfm, dimenet, dlrm, two_tower
from repro_torch.models.transformer import (Transformer, TransformerConfig,
                                            layer_groups, param_shapes)
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
    model = Transformer(c, device)
    load_transformer_params(model, params)
    return model


def _lm_leaves(model: Transformer):
    """(JAX path, port parameter name, parameter) of every parameter of
    ``model``: the path ``(key,)`` of a top-level leaf, ``(group, leaf,
    i)`` of layer i of a stacked group."""
    groups = {name: layers for name, layers, _ in model.groups()}
    offsets = {"dense": 0, "moe": layer_groups(model.config)[0]}
    for name, shape in param_shapes(model.config).items():
        if not isinstance(shape, dict):
            yield (name,), name, getattr(model, name)
            continue
        group = name.split("_")[0]
        for leaf in shape:
            for i, layer in enumerate(groups[group]):
                yield ((name, leaf, i), f"layers.{offsets[group] + i}.{leaf}",
                       getattr(layer, leaf))


def _lm_get(tree: Dict[str, Any], path: tuple) -> Any:
    """The leaf at ``path`` (:func:`_lm_leaves`) of a JAX LM tree, row i
    of a stacked leaf."""
    if len(path) == 1:
        return tree[path[0]]
    return tree[path[0]][path[1]][path[2]]


def _as_f32(src: Any) -> torch.Tensor:
    """A numpy (any float dtype, ml_dtypes' bf16 included) or torch leaf
    as an f32 CPU tensor."""
    if isinstance(src, torch.Tensor):
        return src.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(src, dtype=np.float32))


@torch.no_grad()
def load_transformer_params(model: Transformer,
                            params: Dict[str, Any]) -> None:
    """Copy the JAX-layout tree ``params`` (numpy or torch leaves, layers
    stacked ``[L, ...]`` per group) into ``model``'s parameters IN PLACE,
    cast to their dtype.  A leaf of the wrong shape raises, naming it."""
    shapes = param_shapes(model.config)
    for name, shape in shapes.items():
        if isinstance(shape, dict):
            for leaf, stacked in shape.items():
                got = tuple(params[name][leaf].shape)
                if got != stacked:
                    raise ValueError(f"{name}.{leaf}: shape {got}, "
                                     f"expected {stacked}")
        elif tuple(params[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(params[name].shape)}, "
                             f"expected {shape}")
    for path, _, p in _lm_leaves(model):
        p.copy_(_as_f32(_lm_get(params, path)))


def _lm_tree(model: Transformer, leaf_of) -> Dict[str, Any]:
    """The JAX-layout tree of ``leaf_of(parameter)`` over ``model``'s
    parameters (host tensors), each group's layers stacked ``[L,
    ...]``."""
    tree: Dict[str, Any] = {}
    rows: Dict[tuple, List[torch.Tensor]] = {}
    for path, _, p in _lm_leaves(model):
        x = leaf_of(p).detach().to("cpu", copy=True)
        if len(path) == 1:
            tree[path[0]] = x
        else:
            rows.setdefault(path[:2], []).append(x)
    for (group, leaf), xs in rows.items():
        tree.setdefault(group, {})[leaf] = torch.stack(xs)
    return tree


def transformer_params_tree(model: Transformer) -> Dict[str, Any]:
    """``model``'s parameters as the JAX parameter tree, in its dtype:
    host tensors, each group's layers stacked ``[L, ...]`` (what the
    training driver checkpoints)."""
    return _lm_tree(model, lambda p: p)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bf16 widened to f32 exactly (numpy has no
    bf16)."""
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def transformer_params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The inverse of :func:`transformer_params_from_numpy`: ``model``'s
    parameters as the JAX parameter tree of numpy leaves, layers stacked
    ``[L, ...]`` per group; bf16 leaves widened to f32 (exactly)."""
    return _map_tree(_to_numpy, transformer_params_tree(model))


def _map_tree(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


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


def _leaf_getter(model: torch.nn.Module):
    """``(tree, name) -> leaf``: where port parameter ``name`` of
    ``model`` lies in a JAX tree over its parameters."""
    if not isinstance(model, Transformer):
        return _jax_leaf
    paths = {name: path for path, name, _ in _lm_leaves(model)}
    return lambda tree, name: _lm_get(tree, paths[name])


def opt_state_from_numpy(optimizer: ClippedOptimizer,
                         model: torch.nn.Module, state: Any) -> None:
    """Install a JAX ``OptState`` (``jax.tree.map(np.asarray, ...)`` of
    one, or a port :class:`OptState`) in ``optimizer``, the port's
    optimizer over ``model``: the step count and every leaf's state,
    matched by parameter name, copied IN PLACE."""
    step, inner = state
    leaf = _leaf_getter(model)
    # JAX's inner tree: AdamW's {"m": tree, "v": tree}, SGD's the
    # momentum tree, Adafactor's a tree of {"v"} or {"vr", "vc"} dicts
    for name, st in _named_state(optimizer, model):
        if isinstance(optimizer, AdamW):
            src = {k: leaf(inner[k], name) for k in ("m", "v")}
        elif isinstance(optimizer, SGD):
            src = {"m": leaf(inner, name)}
        else:
            src = leaf(inner, name)
        if set(src) != set(st):
            raise ValueError(f"{name}: state {sorted(src)}, the port's "
                             f"optimizer holds {sorted(st)}")
        for k, dst in st.items():
            arr = _as_f32(src[k])
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{name}.{k}: shape {tuple(arr.shape)}, "
                                 f"expected {tuple(dst.shape)}")
            dst.copy_(arr)
    optimizer.n_steps = int(step)


def opt_state_to_numpy(optimizer: ClippedOptimizer,
                       model: torch.nn.Module) -> OptState:
    """``optimizer``'s state as the JAX ``OptState`` tree: ``step`` an
    int32 scalar, ``inner`` numpy leaves laid out as the reference's
    optimizer over ``model``'s parameter tree lays them out (an LM's
    layers stacked ``[L, ...]`` per group)."""
    if isinstance(model, Transformer):
        state = lm_opt_state_tree(optimizer, model)
        return OptState(step=np.asarray(state.step.item(), np.int32),
                        inner=_map_tree(_to_numpy, state.inner))
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


def lm_opt_state_tree(optimizer: AdamW, model: Transformer) -> OptState:
    """An AdamW over the LM ``model`` as the reference's ``OptState``:
    ``step`` an int32 scalar tensor, ``inner`` ``{"m", "v"}`` trees of
    host tensors in the JAX parameter layout (what the training driver
    checkpoints)."""
    if not isinstance(optimizer, AdamW):
        raise TypeError(f"the LM's optimizer state is AdamW's, not "
                        f"{type(optimizer).__name__}'s")
    inner = {k: _lm_tree(model, lambda p, k=k: optimizer.state[p][k])
             for k in ("m", "v")}
    return OptState(step=torch.tensor(optimizer.n_steps, dtype=torch.int32),
                    inner=inner)
