"""Cell programs: (architecture × input shape) → a runnable program.

The port's counterpart of the JAX package's ``configs/base.py``.  Each
registered architecture has an ``ArchDef`` whose ``cells`` map a shape
name to a builder ``(device=None, seed=0, sizes=None) -> CellProgram``:
the builder makes the cell's inputs as concrete tensors on ``device``
(CUDA unless the caller names another) from ``seed``, and
``prog.fn(*prog.args)`` runs the cell once (``launch/dryrun.py``).
There is no donation: the port's appliers and train steps update in
place.  ``CellProgram.in_shardings`` is the
:class:`~repro_torch.parallel.sharding.Sharding` of the parameters, the
optimizer state, the caches and the batch, computed from shapes only
(:meth:`Cell.shardings`): over the production mesh
(``launch.mesh.make_production_mesh()`` and ``make_rules``) on one
device, where nothing is distributed, and over the live mesh where the
builder is given one.

The mesh route: ``cell(device, seed, sizes, mesh=, rules=)`` with a
named ``DeviceMesh`` (every rank of its process group calls it) builds
the cell as on one device, from the same seed on every rank, then
places it by its own ``in_shardings``: the parameters by
``spmd.shard_module`` (each rank keeps its blocks; the optimizer is made
after, so its state takes their placements, ``adamw_state_pspecs``),
the batch by ``spmd.constrain`` (each leaf a DTensor of the rank's
block), the caches likewise.  ``fn`` then calls the model's step with
``mesh=``, ``rules=``, as every JAX cell of these families does.  The
LM entry points take the global token ids every rank holds and cut
their own blocks, so an LM batch stays whole.  A
DimeNet cell's graph is built as ``dimenet_cfg.partitioned_batch``'s
equal edge partitions, one a rank; ``partitions=`` builds the same graph
globalized for one device (the mesh run's one-device twin).  Nothing
changes without a mesh.

The LM, recommender and GNN builders (:class:`LMCell`,
:class:`RecsysCell`) keep the JAX cell's ``description`` at the
published sizes, count ``model_flops_per_step`` as the JAX cell does at
the sizes the run uses (:meth:`Cell.published_flops` gives the JAX
cell's count), and give the shapes of their inputs without allocating
them (:meth:`Cell.leaves`).  Where a cell does not fit one card,
:func:`cut_rule` cuts its scale (never a width, a sequence length or a
cache length) and names each cut with its bytes in
``CellProgram.reduced``; ``sizes`` overrides the rule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.types import resolve_device
from repro_torch.parallel.sharding import (MeshShape, Sharding,
                                           ShardingRules, Spec, batch_axes,
                                           tree_map)

# a leaf's (shape, dtype), by name
Leaves = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
# the JAX cell's dtype of each of the port's leaf dtypes: ids are int32
# ShapeDtypeStructs there and int64 here (torch's index dtype, which
# ``gather`` and ``F.embedding``'s backward take); floats are the same
JAX_DTYPES = {torch.int64: "int32", torch.int32: "int32",
              torch.float32: "float32", torch.bfloat16: "bfloat16"}

# The cut rule's card: ``torch.cuda.mem_get_info``'s total on an NVIDIA
# H100 80GB HBM3 (79.18 GiB), the default where no card is measured.
H100_BYTES = 85_017_624_576
# an estimated peak within this share of the card: 72.3 GB of the H100's
PEAK_SHARE = 0.85
# training: parameters, gradients and optimizer state within this share
STATE_SHARE = 0.5


@dataclasses.dataclass
class CellProgram:
    """One runnable cell: ``fn(*args)``.

    ``reduced`` names each cut of the published configuration as
    ``{what: "published → used (why)"}``; empty where nothing is cut.
    ``model_flops_per_step`` counts the model's operations for one call
    (an FMA as two), as the JAX cell defines them, at the sizes used.
    ``estimate_bytes`` is the peak device memory the cut rule estimated
    for these sizes (``None`` where the cell has no estimate).
    ``in_shardings``: the :class:`Sharding` of each of the JAX cell's
    arguments (parameters, optimizer state, caches, batch) at these
    sizes over the production mesh, or over ``mesh`` (the live
    ``DeviceMesh`` the cell was placed on by them); ``None`` for a cell
    without one.
    """
    fn: Callable
    args: tuple
    in_shardings: Any = None
    description: str = ""
    model_flops_per_step: float = 0.0
    reduced: Dict[str, str] = dataclasses.field(default_factory=dict)
    estimate_bytes: Optional[float] = None
    mesh: Any = None


@dataclasses.dataclass
class ArchDef:
    name: str
    family: str                   # "lm" | "gnn" | "recsys" | "tifu"
    cells: Dict[str, Callable]    # shape -> builder -> CellProgram
    make_smoke: Callable          # () -> the smoke config
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class Sizes:
    """A model cell's sizes: its model config and its batch (rows,
    sequences or candidates; for a DimeNet cell the power of two its
    graph is divided by).  ``seq``: an LM cell's sequence or cache
    length, ``None`` for the published one."""
    config: Any
    batch: int
    seq: Optional[int] = None


def named(mesh: MeshShape, tree_of_pspecs: Any) -> Any:
    """A tree of :class:`Spec` as :class:`Sharding` over ``mesh``."""
    return tree_map(lambda _, s: Sharding(mesh, s), tree_of_pspecs)


def _shardable(n: int, mesh: MeshShape, axes: Sequence[str]) -> bool:
    """Whether ``axes`` (more than one device) divide ``n``."""
    sizes = mesh.sizes()
    total = math.prod(sizes[a] for a in axes)
    return total > 1 and n % total == 0


def batch_spec(mesh: MeshShape, rules: ShardingRules, n: int) -> Any:
    """The entry of a batch dim of ``n`` rows: the batch axes where they
    divide it, else ``None``."""
    b_ax = batch_axes(mesh, rules)
    return b_ax if _shardable(n, mesh, b_ax) else None


def generator(dev: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def gb(n_bytes: float) -> str:
    return f"{n_bytes / 1e9:.1f} GB"


def card_bytes(dev: torch.device) -> int:
    """The cut rule's device bytes: the card's total on CUDA, else the
    H100's (a host run of a default cell reproduces the card's cuts)."""
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[1]
    return H100_BYTES


def halvings(n: int) -> List[int]:
    """``n``, then every power of two below it, largest first."""
    out = [n]
    p = 1 << (n.bit_length() - 1)
    while p >= 1:
        if p < n:
            out.append(p)
        p //= 2
    return out


# ---------------------------------------------------------------------------
# The cut rule
# ---------------------------------------------------------------------------

# a named cut: (key, sizes, device bytes) -> (sizes, published words,
# used words, why) or None where it does not apply
NamedCut = Callable[[Sizes, float], Optional[Tuple[Sizes, str, str, str]]]


def cut_rule(published: Sizes, peak: Callable[[Sizes], float],
             device_bytes: Optional[float], candidates: Sequence[int], *,
             named: Sequence[Tuple[str, NamedCut]] = (),
             shallower: Optional[Callable[[Any], Any]] = None,
             state: Optional[Callable[[Any], float]] = None,
             depth_words: Callable[[Any], str] = str,
             batch_words: Callable[[int], str] = "{:,}".format
             ) -> Tuple[Sizes, Dict[str, str], float]:
    """The sizes a cell runs at on a card of ``device_bytes``, its
    ``reduced`` entries and its estimated peak bytes (``peak``).

    ``device_bytes=None`` is a card without bound: nothing is cut.  Else,
    in order: the ``named`` cuts that apply (DLRM's capped vocabularies,
    an LM's serving depth); where ``state`` (training's parameters,
    gradients and optimizer state) exceeds ``STATE_SHARE`` of the card,
    one layer less (``shallower``, which keeps each layer kind and
    returns ``None`` at the least depth) until it does not; the first of
    ``candidates`` (batches, largest first) whose peak fits
    ``PEAK_SHARE`` of the card, cutting layers while none does.  Every
    cut is a memory cut: a caller that must also keep within a time
    passes its own ``sizes``.  Raises ``ValueError`` where the least of
    everything exceeds the card itself.
    """
    if device_bytes is None:
        return published, {}, peak(published)
    budget = PEAK_SHARE * device_bytes
    half = STATE_SHARE * device_bytes
    cuts: Dict[str, List[Any]] = {}

    def note(key: str, before: str, after: str, why: str) -> None:
        if key in cuts:
            cuts[key][1] = after
            cuts[key][2].append(why)
        else:
            cuts[key] = [before, after, [why]]

    s = published
    for key, apply in named:
        hit = apply(s, device_bytes)
        if hit is not None:
            s, before, after, why = hit
            note(key, before, after, why)

    def deepest(ok: Callable[[Any], bool]) -> Any:
        """The deepest config from ``s.config`` down for which ``ok``
        holds, one layer at a time (the least depth where none does)."""
        c = s.config
        while not ok(c):
            nxt = None if shallower is None else shallower(c)
            if nxt is None:
                break
            c = nxt
        return c

    if state is not None and state(s.config) > half:
        a = s.config
        b = deepest(lambda c: state(c) <= half)
        why = (f"memory: parameters, gradients and optimizer state "
               f"{gb(state(a))} at {depth_words(a)}, above half the card's "
               f"{gb(device_bytes)}; {gb(state(b))} at {depth_words(b)}")
        if state(b) > half:
            why += ", the least depth that keeps each layer kind"
        note("n_layers", depth_words(a), depth_words(b), why)
        s = dataclasses.replace(s, config=b)

    def at(n: int) -> Sizes:
        return dataclasses.replace(s, batch=n)

    start = s.batch
    candidates = (list(candidates[list(candidates).index(start):])
                  if start in candidates
                  else [start] + [n for n in candidates if n < start])
    least = candidates[-1]
    if peak(at(least)) > budget:
        a = s.config
        b = deepest(lambda c: peak(dataclasses.replace(
            s, config=c, batch=least)) <= budget)
        if b is not a:
            note("n_layers", depth_words(a), depth_words(b),
                 f"memory: estimated peak {gb(peak(at(least)))} at batch "
                 f"{batch_words(least)} and {depth_words(a)}, above the "
                 f"{gb(budget)} budget; "
                 f"{gb(peak(dataclasses.replace(s, config=b, batch=least)))}"
                 f" at {depth_words(b)}")
            s = dataclasses.replace(s, config=b)
    fit = [n for n in candidates if peak(at(n)) <= budget]
    pub_n = published.batch
    if fit:
        n = fit[0]
        if n != start:
            above = candidates[candidates.index(n) - 1]
            note("batch", batch_words(pub_n), batch_words(n),
                 f"memory: estimated peak {gb(peak(at(above)))} at "
                 f"{batch_words(above)}, above the {gb(budget)} budget; "
                 f"{gb(peak(at(n)))} at {batch_words(n)}")
    else:
        n = candidates[-1]
        if peak(at(n)) > device_bytes:
            raise ValueError(
                f"{depth_words(s.config)} at batch {batch_words(n)} "
                f"needs an estimated {gb(peak(at(n)))}, more than the "
                f"card's {gb(device_bytes)}")
        note("batch", batch_words(pub_n), batch_words(n),
             f"memory: estimated peak {gb(peak(at(n)))} at "
             f"{batch_words(n)}, above the {gb(budget)} budget but "
             f"within the card's {gb(device_bytes)}")
    s = at(n)
    reduced = {k: f"{b} → {a} ({'; then '.join(why)})"
               for k, (b, a, why) in cuts.items()}
    return s, reduced, peak(s)


def caller_cut(published: Sizes, used: Sizes,
               config_words: Callable[[Any], str] = str) -> Dict[str, str]:
    """``reduced`` of a run at the caller's ``sizes``: each field that
    differs from the published ones."""
    out = {}
    if used.config != published.config:
        out["config"] = (f"{config_words(published.config)} → "
                         f"{config_words(used.config)} (the caller's sizes)")
    for key in ("batch", "seq"):
        a, b = getattr(published, key), getattr(used, key)
        if b is not None and a != b:
            out[key] = f"{a:,} → {b:,} (the caller's sizes)"
    return out


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

class Cell:
    """A registered cell's builder: ``cell(device=None, seed=0,
    sizes=None) -> CellProgram``.

    ``sizes=None``: the published sizes as :meth:`choose` cuts them for
    the device (``card_bytes``); else the
    caller's :class:`Sizes`.  Subclasses give the JAX cell's
    ``description`` and ``published`` sizes, and :meth:`leaves`,
    :meth:`flops`, :meth:`peak`, :meth:`choose` and :meth:`make`.
    """
    description: str
    published: Sizes

    def leaves(self, sz: Sizes) -> Leaves:
        """The shape and dtype of every batch, cache and token leaf of
        the cell's inputs at ``sz``, built by no allocation."""
        raise NotImplementedError

    def flops(self, sz: Sizes) -> float:
        """The JAX cell's model FLOPs formula at ``sz``."""
        raise NotImplementedError

    def published_flops(self) -> float:
        """The JAX cell's ``model_flops_per_step`` (published sizes)."""
        return self.flops(self.published)

    def peak(self, sz: Sizes) -> float:
        """The estimated peak device bytes of building and running the
        cell at ``sz``."""
        raise NotImplementedError

    def choose(self, device_bytes: Optional[float]
               ) -> Tuple[Sizes, Dict[str, str], float]:
        """:func:`cut_rule`'s sizes, ``reduced`` and estimate."""
        raise NotImplementedError

    def make(self, sz: Sizes, dev: torch.device, seed: int, mesh: Any = None,
             rules: Optional[ShardingRules] = None,
             partitions: Optional[int] = None) -> Tuple[Callable, tuple]:
        """(fn, args) with the inputs built on ``dev`` from ``seed``;
        with ``mesh`` placed by the cell's shardings over it (module
        docstring)."""
        raise NotImplementedError

    def shardings(self, sz: Optional[Sizes] = None,
                  mesh: Optional[MeshShape] = None,
                  rules: Optional[ShardingRules] = None) -> tuple:
        """The JAX cell's ``in_shardings`` at ``sz`` (default: the
        published sizes) over ``mesh`` and ``rules`` (default: the
        production mesh), from shapes only."""
        if mesh is None:
            from repro_torch.launch.mesh import (make_production_mesh,
                                                 make_rules)
            mesh, rules = make_production_mesh(), make_rules()
        return self._shardings(self.published if sz is None else sz,
                               mesh, rules)

    def _shardings(self, sz: Sizes, mesh: MeshShape,
                   rules: ShardingRules) -> tuple:
        raise NotImplementedError

    def config_words(self, c: Any) -> str:
        return getattr(c, "name", str(c))

    def __call__(self, device: Any = None, seed: int = 0,
                 sizes: Optional[Sizes] = None, mesh: Any = None,
                 rules: Optional[ShardingRules] = None,
                 partitions: Optional[int] = None) -> CellProgram:
        dev = resolve_device(device)
        if sizes is None:
            sz, reduced, est = self.choose(card_bytes(dev))
        else:
            sz, est = sizes, self.peak(sizes)
            reduced = caller_cut(self.published, sizes, self.config_words)
        fn, args = self.make(sz, dev, seed, mesh, rules, partitions)
        shardings = self.shardings(sz) if mesh is None else \
            self.shardings(sz, mesh_shape(mesh), rules)
        return CellProgram(fn=fn, args=args, in_shardings=shardings,
                           description=self.description,
                           model_flops_per_step=self.flops(sz),
                           reduced=reduced, estimate_bytes=est, mesh=mesh)


def mesh_shape(mesh: Any) -> MeshShape:
    """A ``DeviceMesh``'s axis names and sizes, what the rules read."""
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def place(tree: Any, shardings: Any, mesh: Any) -> Any:
    """Each tensor of ``tree`` (the global value every rank holds; dicts,
    lists, tuples and dataclasses such as a ``StreamState`` or a batch)
    as the DTensor of its :class:`Sharding`'s spec in ``shardings`` (a
    tree of the same keys or fields): a copy of the rank's block, so the
    whole can be freed, and no collective."""
    from repro_torch.parallel import spmd

    def one(x, s):
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: one(getattr(x, f.name), getattr(s, f.name))
                for f in dataclasses.fields(x)})
        if isinstance(x, (dict, list, tuple)):
            return tree_map(lambda _, a, b: one(a, b), x, s)
        block = spmd.local_block(x, mesh, s.spec).clone()
        return spmd.from_local(block, mesh, s.spec)
    return one(tree, shardings)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def lm_train_flops(c, batch: int, seq: int) -> float:
    return 6.0 * c.n_active_params() * batch * seq


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _numel(shape: Sequence[int]) -> int:
    return int(math.prod(shape))


def lm_leaf_shapes(c) -> List[Tuple[int, ...]]:
    """The shape of every parameter of the port's ``Transformer`` (one
    per layer, unstacked)."""
    from repro_torch.models import transformer as T
    return list(T.named_param_shapes(c).values())


def lm_param_bytes(c) -> int:
    return sum(_numel(s) for s in lm_leaf_shapes(c)) * _itemsize(c.dtype)


def lm_state_bytes(c, optimizer: str) -> int:
    """Parameters, their gradients (the parameters' dtype) and the f32
    optimizer state: AdamW's m and v, Adafactor's factored rows and
    columns where both trailing dims are at least 128, else a full v."""
    shapes = lm_leaf_shapes(c)
    p = sum(_numel(s) for s in shapes)
    if optimizer == "adamw":
        opt = 2 * p
    else:
        opt = sum(_numel(s[:-1]) + _numel(s[:-2]) * s[-1]
                  if len(s) >= 2 and min(s[-2:]) >= 128 else _numel(s)
                  for s in shapes)
    return 2 * p * _itemsize(c.dtype) + 4 * opt


def lm_layer_bytes(c, t: int) -> int:
    """Transient bytes of the largest layer's forward over ``t`` tokens:
    the residual stream and the norm's f32 copy, then the larger of
    attention (Q, K, V and their rotated copies, rotary's f32
    temporaries, the output; MLA's latent projections, the expanded
    keys and values and V padded to the query width) and the FFN (SwiGLU
    over d_ff; the MoE's dispatch buffer, expert hidden states and
    outputs, the router's f32 probabilities and sorts, the shared
    experts)."""
    from repro_torch.models import transformer as T
    e, d = _itemsize(c.dtype), c.d_model
    resid = t * d * (4 * e + 8)
    if c.mla:
        h, qk = c.n_heads, c.qk_dim
        attn = (t * (c.q_lora_rank + c.kv_lora_rank + c.qk_rope_dim) * 2 * e
                + t * h * (5 * qk + c.qk_nope_dim + c.v_dim) * e
                + 12 * t * h * c.qk_rope_dim)
    else:
        attn = t * c.d_head * ((c.n_heads + 2 * c.n_kv_heads) * 2 * e
                               + 12 * c.n_heads + c.n_heads * e)
    attn += t * d * e
    n_dense, n_moe = T.layer_groups(c)
    ffn = 3 * t * c.d_ff * e if n_dense else 0
    if n_moe:
        rows = c.e_pad * T._capacity(t, c)
        ffn = max(ffn, 2 * rows * d * e + 4 * rows * c.moe_d_ff * e
                  + 12 * t * c.n_experts + 48 * t * c.top_k + 3 * t * d * e
                  + 3 * t * c.moe_d_ff * c.n_shared_experts * e)
    return resid + max(attn, ffn)


def lm_cache_bytes(c, batch: int, length: int) -> int:
    from repro_torch.models import transformer as T
    return 2 * sum(_numel(s) for shapes in
                   T.cache_shapes(c, batch, length).values()
                   for s in shapes)


def lm_init_bytes(c) -> int:
    """``transformer.init_params``'s transient: the largest leaf drawn in
    f32 and scaled, two f32 copies (an expert stack [E, ...] one expert
    at a time)."""
    return 8 * max(_numel(s[1:]) if len(s) == 3 else _numel(s)
                   for s in lm_leaf_shapes(c))


def lm_peak_bytes(c, kind: str, batch: int, seq: int,
                  optimizer: str = "adamw") -> int:
    """The estimated peak of an LM cell: the parameters, then the larger
    of their init's transient (:func:`lm_init_bytes`) and the run's.
    ``kind`` "train": the gradients and optimizer state, the layer inputs
    remat keeps, the final hidden states and their gradient, a
    cross-entropy chunk's logits, softmax and gradient in f32 beside the
    unembedding's gradient and the sum it accumulates into, and a
    layer's forward recomputed with its gradients (three times its
    transient); the MTP head's inputs.  "prefill": the caches of ``seq``
    positions and one layer.  "decode": the caches of ``seq`` positions,
    a layer's keys as the score product lays them out again, and one
    query row's f32 scores against them."""
    e, d, t = _itemsize(c.dtype), c.d_model, batch * seq
    params = lm_param_bytes(c)
    if kind == "train":
        chunk = min(512, seq)
        run = (lm_state_bytes(c, optimizer) - params
               + c.n_layers * t * d * e + 4 * t * d * e
               + batch * chunk * c.vocab_size * (e + 12)
               + 2 * c.vocab_size * d * e + 3 * lm_layer_bytes(c, t)
               + (8 * t * d * e if c.mtp else 0))
    elif kind == "prefill":
        run = lm_cache_bytes(c, batch, seq) + lm_layer_bytes(c, t) \
            + 2 * t * d * e
    else:
        caches = lm_cache_bytes(c, batch, seq)
        run = caches + caches // (2 * c.n_layers) \
            + batch * c.n_heads * seq * (16 + 3 * e) \
            + lm_layer_bytes(c, batch)
    return params + max(lm_init_bytes(c), run)


def _lm_kinds(c) -> Tuple[int, int, int]:
    """(dense or local layers, MoE or global layers, the least depth
    that keeps each kind)."""
    from repro_torch.models import transformer as T
    n_dense, n_moe = T.layer_groups(c)
    if n_dense and n_moe:
        return n_dense, n_moe, 2
    if c.sliding_window and c.global_every:
        n_glob = c.n_layers // c.global_every
        return c.n_layers - n_glob, n_glob, 2 if n_glob else 1
    return c.n_layers, 0, 1


def lm_with_depth(c, n_layers: int):
    """``c`` at ``n_layers``, each layer kind kept: a MoE model keeps a
    leading dense layer (and at least one MoE layer); a model with
    global layers every ``global_every`` keeps one, last, where fewer
    layers than the pattern remain."""
    kw: Dict[str, int] = {"n_layers": n_layers}
    if c.moe and c.first_dense_layers:
        kw["first_dense_layers"] = max(1, min(c.first_dense_layers,
                                              n_layers - 1))
    if c.sliding_window and c.global_every \
            and n_layers // c.global_every == 0:
        kw["global_every"] = n_layers
    return dataclasses.replace(c, **kw)


def lm_shallower(c):
    """One layer less, each kind kept; ``None`` at the least depth."""
    least = _lm_kinds(c)[2]
    return None if c.n_layers <= least else lm_with_depth(c, c.n_layers - 1)


def lm_depth_words(c) -> str:
    from repro_torch.models import transformer as T
    n_dense, n_moe = T.layer_groups(c)
    if n_dense and n_moe:
        return f"{c.n_layers} layers ({n_dense} dense + {n_moe} MoE)"
    if c.sliding_window and c.global_every:
        local, glob, _ = _lm_kinds(c)
        return f"{c.n_layers} layers ({local} local + {glob} global)"
    return f"{c.n_layers} layer{'s' if c.n_layers > 1 else ''}"


class LMCell(Cell):
    """An LM cell of the JAX registry: ``kind`` "train" (``fn`` the
    port's ``transformer.make_train_step`` over a seeded model, the
    port's ``adamw(total_steps=10000)`` or ``adafactor()`` and a
    ``{"tokens", "labels"}`` batch), "prefill" (``Transformer.prefill(
    tokens, max_len=seq)``) or "decode" (``Transformer.decode_step(
    caches, token, pos)`` against caches of ``seq`` positions filled
    with seeded bf16 values, ``pos = seq − 1``, so the step reads the
    whole cache).  ``serve_depth``: the depth the arch runs at where
    the card cannot hold the model (its bf16 parameters above half the
    card)."""

    def __init__(self, make_config: Callable, kind: str, batch: int,
                 seq: int, optimizer: str = "adamw",
                 serve_depth: Optional[int] = None):
        self.make_config, self.kind, self.seq = make_config, kind, seq
        self.optimizer, self.serve_depth = optimizer, serve_depth
        self.published = Sizes(make_config(), batch, seq)
        self.description = {
            "train": f"train_step B={batch} S={seq}",
            "prefill": f"prefill B={batch} S={seq}",
            "decode": f"decode_step B={batch} cache={seq}"}[kind]

    def _seq(self, sz: Sizes) -> int:
        return self.seq if sz.seq is None else sz.seq

    def leaves(self, sz: Sizes) -> Leaves:
        from repro_torch.models import transformer as T
        b, s, i64 = sz.batch, self._seq(sz), torch.int64
        if self.kind == "train":
            return {"tokens": ((b, s), i64), "labels": ((b, s), i64)}
        if self.kind == "prefill":
            return {"tokens": ((b, s), i64)}
        out: Leaves = {}
        for group, shapes in T.cache_shapes(sz.config, b, s).items():
            for i, shape in enumerate(shapes):
                out[f"caches/{group}/{i}"] = (shape, torch.bfloat16)
        out["token"] = ((b, 1), i64)
        return out

    def flops(self, sz: Sizes) -> float:
        c, b = sz.config, sz.batch
        if self.kind == "train":
            return lm_train_flops(c, b, self._seq(sz))
        if self.kind == "prefill":
            return 2.0 * c.n_active_params() * b * self._seq(sz)
        return 2.0 * c.n_active_params() * b

    def peak(self, sz: Sizes) -> float:
        return float(lm_peak_bytes(sz.config, self.kind, sz.batch,
                                   self._seq(sz), self.optimizer))

    def _serve_depth(self, sz: Sizes, device_bytes: float):
        c = sz.config
        params = lm_param_bytes(c)
        if self.serve_depth is None or params <= STATE_SHARE * device_bytes:
            return None
        cut = lm_with_depth(c, self.serve_depth)
        return (dataclasses.replace(sz, config=cut), lm_depth_words(c),
                lm_depth_words(cut),
                f"memory: its {gb(params)} of bf16 parameters exceed half "
                f"the card's {gb(device_bytes)}: the serving depth, "
                f"{gb(lm_param_bytes(cut))}")

    def choose(self, device_bytes):
        train = self.kind == "train"
        return cut_rule(
            self.published, self.peak, device_bytes,
            halvings(self.published.batch),
            named=[("n_layers", self._serve_depth)],
            shallower=lm_shallower,
            state=(lambda c: lm_state_bytes(c, self.optimizer)) if train
            else None,
            depth_words=lm_depth_words)

    def _shardings(self, sz, mesh, rules):
        from repro_torch.models import transformer as T
        from repro_torch.optim import optimizers
        c, b = sz.config, sz.batch
        pspecs = T.param_pspecs(c, mesh, rules)
        params = named(mesh, pspecs)
        bspec = Sharding(mesh, Spec(batch_spec(mesh, rules, b), None))
        if self.kind == "train":
            opt = (optimizers.adamw_state_pspecs(pspecs)
                   if self.optimizer == "adamw"
                   else optimizers.adafactor_state_pspecs(
                       T.named_param_shapes(c), pspecs))
            return (params, named(mesh, opt),
                    {"tokens": bspec, "labels": bspec})
        if self.kind == "prefill":
            return params, bspec
        return (params, named(mesh, _cache_pspecs(c, b, self._seq(sz), mesh,
                                                  rules)),
                bspec, Sharding(mesh, Spec()))

    def make(self, sz: Sizes, dev: torch.device, seed: int, mesh=None,
             rules=None, partitions=None):
        from repro_torch.models import transformer as T
        from repro_torch.optim import optimizers
        from repro_torch.parallel import spmd
        c, b, s = sz.config, sz.batch, self._seq(sz)
        gen = generator(dev, seed)
        model = T.init_params(c, gen, dev)
        if mesh is not None:
            spmd.shard_module(model, mesh, T.param_pspecs(
                c, mesh_shape(mesh), rules))
        if self.kind == "train":
            opt = (optimizers.adamw(model.parameters(), total_steps=10000)
                   if self.optimizer == "adamw"
                   else optimizers.adafactor(model.parameters()))
            toks = torch.randint(0, c.vocab_size, (b, s + 1), generator=gen,
                                 device=dev)
            batch = {"tokens": toks[:, :-1].contiguous(),
                     "labels": toks[:, 1:].contiguous()}
            return T.make_train_step(c, opt, mesh, rules), (model, batch)
        if self.kind == "prefill":
            tokens = torch.randint(0, c.vocab_size, (b, s), generator=gen,
                                   device=dev)

            def prefill(model, tokens):
                return model.prefill(tokens, max_len=s, mesh=mesh,
                                     rules=rules)
            return prefill, (model, tokens)
        caches = {}
        for group, shapes in T.cache_shapes(c, b, s).items():
            pair = tuple(torch.empty(shape, dtype=torch.bfloat16,
                                     device=dev) for shape in shapes)
            for t in pair:
                for layer in t:          # one layer at a time
                    layer.normal_(generator=gen)
            caches[group] = pair
        token = torch.randint(0, c.vocab_size, (b, 1), generator=gen,
                              device=dev)
        if mesh is not None:
            caches = place(caches, named(mesh_shape(mesh), _cache_pspecs(
                c, b, s, mesh_shape(mesh), rules)), mesh)

        def decode(model, caches, token, pos):
            return model.decode_step(caches, token, pos, mesh, rules)
        return decode, (model, caches, token, s - 1)


def _cache_pspecs(c, batch: int, length: int, mesh: MeshShape,
                  rules: ShardingRules) -> Dict[str, Tuple[Spec, Spec]]:
    """The caches' specs: B over the batch axes where they divide it and
    S over the context axis, else S over ("data", "model") and B
    replicated; the layer dim of each stack replicated."""
    from repro_torch.models import transformer as T
    if _shardable(batch, mesh, batch_axes(mesh, rules)):
        bs = batch_axes(mesh, rules)
        s_ax = rules.context if rules.context in mesh.axis_names else None
    else:
        bs = None
        s_ax = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    return {group: tuple(Spec(None, bs, s_ax, *([None] * (len(s) - 3)))
                         for s in shapes)
            for group, shapes in T.cache_shapes(c, batch, length).items()}


def lm_train_cell(make_config, global_batch: int, seq: int,
                  optimizer: str = "adamw", serve_depth=None) -> LMCell:
    return LMCell(make_config, "train", global_batch, seq, optimizer,
                  serve_depth)


def lm_prefill_cell(make_config, global_batch: int, seq: int,
                    serve_depth=None) -> LMCell:
    return LMCell(make_config, "prefill", global_batch, seq,
                  serve_depth=serve_depth)


def lm_decode_cell(make_config, global_batch: int, cache_len: int,
                   serve_depth=None) -> LMCell:
    return LMCell(make_config, "decode", global_batch, cache_len,
                  serve_depth=serve_depth)


# ---------------------------------------------------------------------------
# RecSys family (and DimeNet's training cells)
# ---------------------------------------------------------------------------

class CellBatch:
    """A recommender or GNN cell's batch of ``n`` rows (published
    ``n``): :meth:`leaves` its shapes at a config and a row count,
    :meth:`make` the seeded tensors, :meth:`candidates` the counts the
    cut rule tries, largest first."""
    n: int
    cut_note = ""         # added to the batch's entry in ``reduced``

    def leaves(self, c, n: int) -> Leaves:
        raise NotImplementedError

    def make(self, c, n: int, gen: torch.Generator, seed: int
             ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    # whether a sharded run splits the batch into equal partitions of its
    # own, one a rank (DimeNet's edge partitions)
    partitioned = False

    def make_partitioned(self, c, n: int, gen: torch.Generator, seed: int,
                         parts: int, local: bool) -> Dict[str, torch.Tensor]:
        """The batch as ``parts`` equal partitions: ``local`` the sharded
        run's form, else globalized for one device."""
        raise NotImplementedError

    def shardings(self, c, n: int, mesh: MeshShape,
                  rules: ShardingRules) -> Dict[str, Sharding]:
        """The JAX batch builder's sharding of each leaf."""
        raise NotImplementedError

    def candidates(self) -> List[int]:
        return halvings(self.n)

    def words(self, n: int) -> str:
        return f"{n:,}"


class RecsysCell(Cell):
    """The JAX ``recsys_cell``: a seeded ``module.init_params`` model and
    ``batch``; ``train`` runs ``module.make_train_step(c, adamw(
    total_steps=10000), **train_kwargs)``, else ``getattr(module,
    serve_fn)(model, batch, c)``.  ``peak_fn(c, n)`` estimates the
    cell's peak bytes, ``flops_fn(c, n)`` the JAX arch's count; ``named`` the
    arch's fixed cuts (:data:`NamedCut`); ``serve_kwargs(c)`` the
    serving call's keywords beyond these, where a config sets them.  On
    the mesh route the step takes ``mesh=``, ``rules=`` (the JAX cell's
    ``mesh_kw``: every recommender and GNN cell passes the mesh)."""

    def __init__(self, module: Any, make_config: Callable,
                 batch: CellBatch, kind: str, flops_fn=None,
                 train: bool = False, serve_fn: str = "serve_step",
                 train_kwargs: Optional[dict] = None, peak_fn=None,
                 named: Sequence[Tuple[str, NamedCut]] = (),
                 serve_kwargs: Optional[Callable] = None):
        self.module, self.batch, self.train = module, batch, train
        self.serve_fn, self.train_kwargs = serve_fn, train_kwargs or {}
        self.serve_kwargs = serve_kwargs
        self.flops_fn, self.peak_fn, self.named = flops_fn, peak_fn, named
        self.description = kind
        self.published = Sizes(make_config(), batch.n)

    def leaves(self, sz: Sizes) -> Leaves:
        return self.batch.leaves(sz.config, sz.batch)

    def _shardings(self, sz, mesh, rules):
        from repro_torch.optim import optimizers
        pspecs = self.module.param_pspecs(sz.config, mesh, rules)
        batch = self.batch.shardings(sz.config, sz.batch, mesh, rules)
        if self.train:
            return (named(mesh, pspecs),
                    named(mesh, optimizers.adamw_state_pspecs(pspecs)),
                    batch)
        return named(mesh, pspecs), batch

    def flops(self, sz: Sizes) -> float:
        return self.flops_fn(sz.config, sz.batch) if self.flops_fn else 0.0

    def peak(self, sz: Sizes) -> float:
        return float(self.peak_fn(sz.config, sz.batch))

    def choose(self, device_bytes):
        sz, reduced, est = cut_rule(
            self.published, self.peak, device_bytes,
            self.batch.candidates(), named=self.named,
            batch_words=self.batch.words)
        if "batch" in reduced and self.batch.cut_note:
            reduced["batch"] = (f"{reduced['batch'][:-1]}; "
                                f"{self.batch.cut_note})")
        return sz, reduced, est

    def make(self, sz: Sizes, dev: torch.device, seed: int, mesh=None,
             rules=None, partitions=None):
        from repro_torch.optim import optimizers
        from repro_torch.parallel import spmd
        c, module = sz.config, self.module
        gen = generator(dev, seed)
        model = module.init_params(c, gen, dev)
        if mesh is not None and self.batch.partitioned:
            partitions = mesh.size()
        if partitions:
            batch = self.batch.make_partitioned(c, sz.batch, gen, seed,
                                                partitions, mesh is not None)
        else:
            batch = self.batch.make(c, sz.batch, gen, seed)
        kw: Dict[str, Any] = {}
        if mesh is not None:
            shape = mesh_shape(mesh)
            spmd.shard_module(model, mesh,
                              module.param_pspecs(c, shape, rules))
            batch = place(batch, self.batch.shardings(c, sz.batch, shape,
                                                      rules), mesh)
            kw = {"mesh": mesh, "rules": rules}
        if self.train:
            opt = optimizers.adamw(model.parameters(), total_steps=10000)
            return (module.make_train_step(c, opt, **self.train_kwargs,
                                           **kw), (model, batch))
        serve = getattr(module, self.serve_fn)
        if self.serve_kwargs is not None:
            kw.update(self.serve_kwargs(c))

        def fn(model, batch):
            return serve(model, batch, c, **kw)
        return fn, (model, batch)


def recsys_cell(module, make_config, batch_builder: CellBatch, kind: str,
                flops_fn=None, train: bool = False, serve_fn="serve_step",
                train_kwargs: Optional[dict] = None, peak_fn=None,
                named=(), serve_kwargs=None) -> RecsysCell:
    """Generic builder for the recommender and GNN models (the JAX
    ``recsys_cell``; the mesh route calls the step with ``mesh=``,
    ``rules=``, as the JAX cells' ``pass_mesh=True`` does)."""
    return RecsysCell(module, make_config, batch_builder, kind, flops_fn,
                      train, serve_fn, train_kwargs, peak_fn, named,
                      serve_kwargs)

