"""Retained-equivalence certification (GDPR unlearning, DESIGN.md §11).

Given an engine and the event log it processed, prove the unlearning
property the deletion paths exist for: the maintained state must be
equivalent to a model that was fit on the **retained** data only, and a
forgotten user must leave **no trace** in any live or persisted
artifact.  The paper's §4.3 varying-group-size relaxation makes exact
retrain-equivalence unattainable after a deletion -- the maintained
group structure is path-dependent -- so the certificate is layered:

* **structural** -- the engine's stored history must contain exactly the
  retained baskets (an event-by-event semantic replay of the log), for
  every user.  A skipped or phantom deletion fails here.
* **pure-add bitwise** -- users never touched by a deletion must match a
  fresh engine replay of their add events bit for bit, on every state
  leaf (the add path is deterministic and row-independent).
* **path fit** -- deletion-bearing users must match the Eq. 1+2 closed
  form evaluated on (retained history, *maintained* group structure)
  within a small float envelope.
* **canonical envelope** -- against the from-scratch retained-only fit
  (canonical ``default_group_sizes`` regrouping) the divergence is
  bounded by the per-user envelope of :func:`divergence_envelope`.
* **top-n overlap** -- serving from the maintained corpus and from the
  canonical retained-only corpus must agree on at least
  ``overlap_floor`` of each top-n list on average.
* **no trace** -- a forgotten user's rows are exactly zero in the state,
  the fp32 and int8 serving caches, and a checkpoint round trip; the
  dead-letter queues hold none of their events.

The port of ``repro.compliance.certify``: the same checks, report and
floats (the closed forms stay numpy float64 on the host).  The engine's
leaves are materialized on its device and copied to the host once a
leaf; the pure-add replay runs on a fresh store on the engine's device;
the overlap check serves every active user in one
``knn.recommend_for_users`` call per corpus (on the card the ``knn_topk``
and ``blend_topn_onehot`` kernels).  Works on both
:class:`~repro_torch.streaming.StreamingEngine` and
:class:`~repro_torch.streaming.ShardedStreamingEngine`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import knn
from repro_torch.core.tifu import default_group_sizes, user_vector_ragged
from repro_torch.core.types import (KIND_ADD_BASKET, KIND_DEL_BASKET,
                                    KIND_DEL_ITEM, TifuParams)
from repro_torch.streaming import (Event, ShardedStreamingEngine,
                                   StateStore, StoreConfig, StreamingEngine,
                                   load_checkpoint_arrays)

# Float envelope for the path-fit check: the f32 engine accumulates
# roundoff relative to the exact closed form; the JAX package's parity
# suites pin it at 1e-4 against the f32 RefEngine over comparable
# stream lengths.
DEFAULT_PATH_ATOL = 2e-4


@dataclasses.dataclass(frozen=True)
class CheckResult:
    """One named certification check: pass/fail plus a human detail."""

    name: str
    ok: bool
    detail: str


@dataclasses.dataclass
class ComplianceReport:
    """The typed outcome of :func:`certify`.

    ``checks`` carries one :class:`CheckResult` per certification layer;
    ``envelope_slack`` is the worst observed margin of the canonical
    comparison below its derived bound (negative = inside the bound),
    and ``overlap_mean`` the measured top-n agreement.
    """

    n_users: int
    n_events: int
    n_deletion_events: int
    pure_add_users: List[int]
    deletion_users: List[int]
    forgotten_users: List[int]
    checks: List[CheckResult]
    envelope_slack: float = float("-inf")
    overlap_mean: float = 1.0

    @property
    def compliant(self) -> bool:
        """True when every certification check passed."""
        return all(c.ok for c in self.checks)

    @property
    def violations(self) -> List[CheckResult]:
        """The failed checks (empty for a compliant engine)."""
        return [c for c in self.checks if not c.ok]

    def summary(self) -> str:
        """One line per check, for logs and assertion messages."""
        lines = [f"compliant={self.compliant} users={self.n_users} "
                 f"events={self.n_events} "
                 f"deletions={self.n_deletion_events}"]
        for c in self.checks:
            lines.append(f"  [{'ok' if c.ok else 'FAIL'}] "
                         f"{c.name}: {c.detail}")
        return "\n".join(lines)


def retained_histories(events: Iterable[Event],
                       n_users: int) -> List[List[np.ndarray]]:
    """Semantic replay of the event log: each user's retained baskets.

    Applies the log's events in order with the same guards the engine
    enforces at apply time (a delete position at or beyond the current
    history length is a quarantined no-op; deleting an absent item is a
    no-op), so the result is the per-user basket list a compliant engine
    must hold.  Per-user order is the log order -- the engine's
    one-event-per-user-per-micro-batch cut preserves exactly that.
    """
    hist: List[List[np.ndarray]] = [[] for _ in range(n_users)]
    for ev in events:
        h = hist[ev.user]
        if ev.kind == KIND_ADD_BASKET:
            h.append(np.unique(np.asarray(ev.items, np.int64).ravel()))
        elif ev.kind == KIND_DEL_BASKET:
            if 0 <= ev.pos < len(h):
                del h[ev.pos]
        elif ev.kind == KIND_DEL_ITEM:
            if 0 <= ev.pos < len(h):
                b = h[ev.pos]
                if ev.item in b:
                    b = b[b != ev.item]
                    if b.size:
                        h[ev.pos] = b
                    else:
                        del h[ev.pos]
    return hist


def basket_weights(group_sizes: Sequence[int], r_b: float,
                   r_g: float) -> np.ndarray:
    """Per-basket scalar weight of Eq. 1+2 under a given partition.

    The user vector is linear in the basket multi-hots: ``v_u = sum_t
    w(t) * mh(b_t)`` where basket ``t`` sits at in-group position ``i``
    (1-based) of group ``j`` (0-based) of ``k`` groups and

        ``w(t) = r_g^(k-1-j) / k  *  r_b^(tau_j - i) / tau_j``.

    The partition fully determines the weights -- the scalar footprint
    the §4.3 path dependence acts on (DESIGN.md §11.2).
    """
    k = len(group_sizes)
    w = []
    for j, tau in enumerate(group_sizes):
        for i in range(1, tau + 1):
            w.append((r_g ** (k - 1 - j)) / k * (r_b ** (tau - i)) / tau)
    return np.asarray(w, np.float64)


def divergence_envelope(maintained_sizes: Sequence[int],
                        canonical_sizes: Sequence[int], r_b: float,
                        r_g: float) -> float:
    """The §4.3 path-dependence bound ``E_u`` (DESIGN.md §11.2).

    Both the maintained (path-dependent) and the canonical retained-only
    fit are weighted sums of the SAME basket multi-hots, so with
    ``w_path``/``w_canon`` from :func:`basket_weights`:

        ``||v_path - v_canon||_inf <= sum_t |w_path(t) - w_canon(t)|``

    because every multi-hot entry is 0 or 1.  The bound is tight (met
    when all baskets share an item) and computable per user in
    O(n_baskets).
    """
    wp = basket_weights(maintained_sizes, r_b, r_g)
    wc = basket_weights(canonical_sizes, r_b, r_g)
    if wp.size != wc.size:
        raise ValueError(f"partitions cover {wp.size} vs {wc.size} "
                         "baskets — not the same history")
    return float(np.abs(wp - wc).sum())


# ---------------------------------------------------------------------------
# Engine introspection (single engine and sharded)
# ---------------------------------------------------------------------------

def _engines(engine) -> List[Tuple[StreamingEngine, np.ndarray]]:
    """(shard engine, global user ids of its rows) pairs."""
    if isinstance(engine, ShardedStreamingEngine):
        out = []
        for s, sh in enumerate(engine.shards):
            rows = np.arange(sh.store.cfg.n_users, dtype=np.int64)
            out.append((sh, rows * engine.spec.n_shards + s))
        return out
    return [(engine,
             np.arange(engine.store.cfg.n_users, dtype=np.int64))]


def _n_users(engine) -> int:
    if isinstance(engine, ShardedStreamingEngine):
        return engine.spec.n_users
    return engine.store.cfg.n_users


def _first_store(engine) -> StateStore:
    """The store whose config and device a fresh replay takes."""
    if isinstance(engine, ShardedStreamingEngine):
        return engine.shards[0].store
    return engine.store


def _global_leaves(engine) -> Dict[str, np.ndarray]:
    """Assemble global per-user host views of every state leaf + corpus.

    Each shard's corpus is materialized on its device; every leaf is
    then copied to the host once.
    """
    n = _n_users(engine)
    out: Dict[str, np.ndarray] = {}
    leaf_names = ("user_vecs", "last_group_vecs", "history", "group_sizes",
                  "n_baskets", "n_groups", "err_mult", "uv_scale",
                  "lgv_scale")
    for sh, gids in _engines(engine):
        st = sh.store.state
        mat = st.materialized_user_vecs()
        for name in leaf_names + ("corpus",):
            t = mat if name == "corpus" else getattr(st, name)
            a = t.detach().cpu().numpy()
            if name not in out:
                out[name] = np.zeros((n,) + a.shape[1:], a.dtype)
            out[name][gids] = a
        del mat
    return out


def _dead_letter_users(engine) -> set:
    """Global user ids present in any dead-letter queue."""
    out = set()
    if isinstance(engine, ShardedStreamingEngine):
        for ev, _ in engine.dead_letter:
            out.add(int(ev.user))
        for s, sh in enumerate(engine.shards):
            for ev, _ in sh.dead_letter:
                out.add(int(ev.user) * engine.spec.n_shards + s)
    else:
        for ev, _ in engine.dead_letter:
            out.add(int(ev.user))
    return out


# ---------------------------------------------------------------------------
# The certifier
# ---------------------------------------------------------------------------

def _structural_check(hist, leaves) -> CheckResult:
    """Stored history == retained baskets, per user, exactly."""
    bad = []
    for u, retained in enumerate(hist):
        nb = int(leaves["n_baskets"][u])
        if nb != len(retained):
            bad.append(f"user {u}: {nb} stored vs {len(retained)} "
                       "retained basket(s)")
            continue
        for t, basket in enumerate(retained):
            row = leaves["history"][u, t]
            stored = np.sort(row[row >= 0])
            if not np.array_equal(stored, np.sort(basket)):
                bad.append(f"user {u} basket {t}: stored "
                           f"{stored.tolist()} != retained "
                           f"{np.sort(basket).tolist()}")
                break
        k = int(leaves["n_groups"][u])
        if int(leaves["group_sizes"][u, :k].sum()) != len(retained):
            bad.append(f"user {u}: group sizes do not cover the "
                       "retained history")
    return CheckResult(
        "structural-retained-equivalence", not bad,
        bad[0] if bad else "stored history == retained events, all users")


def _pure_add_bitwise_check(engine, events, pure_add, leaves,
                            params) -> CheckResult:
    """Fresh replay of pure-add users' events must match bit for bit.

    The fresh store takes the config and the device of the engine's
    (first) store.  A failure names the first differing users and both
    engines' stability-refresh counts.
    """
    if not pure_add:
        return CheckResult("pure-add-bitwise", True, "no pure-add users")
    src = _first_store(engine)
    cfg = src.cfg
    store = StateStore(StoreConfig(
        n_users=_n_users(engine), n_items=cfg.n_items,
        max_baskets=cfg.max_baskets, max_basket_size=cfg.max_basket_size,
        max_groups=cfg.max_groups), device=src.device)
    fresh = StreamingEngine(store, params)
    keep = set(pure_add)
    fresh.submit([Event(ev.kind, ev.user, items=ev.items)
                  for ev in events if ev.user in keep])
    fresh.run_until_drained()
    ref = _global_leaves(fresh)
    rows = np.asarray(pure_add, np.int64)
    for name in ("user_vecs", "uv_scale", "last_group_vecs", "lgv_scale",
                 "history", "group_sizes", "n_baskets", "n_groups",
                 "err_mult"):
        a, b = leaves[name][rows], ref[name][rows]
        if not np.array_equal(a, b):
            differ = ~np.all((a == b).reshape(rows.size, -1), axis=1)
            users = rows[differ]
            refreshes = sum(sh.metrics.refreshes
                            for sh, _ in _engines(engine))
            return CheckResult(
                "pure-add-bitwise", False,
                f"leaf {name!r} differs from a fresh replay for "
                f"{users.size} of {len(pure_add)} pure-add user(s), the "
                f"first {users[:8].tolist()}; stability refreshes: engine "
                f"{refreshes}, fresh replay {fresh.metrics.refreshes}")
    return CheckResult(
        "pure-add-bitwise", True,
        f"{len(pure_add)} user(s) bitwise-equal to a fresh replay")


def _deletion_checks(hist, leaves, deletion_users, params,
                     path_atol) -> Tuple[List[CheckResult], float,
                                         np.ndarray]:
    """Path-fit and canonical-envelope checks for deletion users.

    Returns the two checks, the worst envelope slack, and the canonical
    retained-only corpus rows for the overlap comparison.
    """
    canon = np.array(leaves["corpus"], np.float32, copy=True)
    if not deletion_users:
        return ([CheckResult("path-fit", True, "no deletion-bearing "
                             "users"),
                 CheckResult("canonical-envelope", True,
                             "no deletion-bearing users")],
                float("-inf"), canon)
    path_bad: List[str] = []
    env_bad: List[str] = []
    worst_slack = float("-inf")
    for u in deletion_users:
        retained = hist[u]
        k = int(leaves["n_groups"][u])
        sizes = [int(x) for x in leaves["group_sizes"][u, :k]]
        if sum(sizes) != len(retained):
            # the structural check reports this divergence; the float
            # comparisons are meaningless against a wrong basket count
            path_bad.append(f"user {u}: maintained partition covers "
                            f"{sum(sizes)} basket(s), retained history "
                            f"has {len(retained)} — skipped float "
                            "comparison")
            continue
        v_m = leaves["corpus"][u].astype(np.float64)
        # (a) the maintained float row is the Eq. 1+2 closed form on
        # (retained history, maintained partition) up to f32 roundoff
        v_path = user_vector_ragged(retained, sizes, params)
        d_path = float(np.abs(v_m - v_path).max()) if len(retained) \
            else float(np.abs(v_m).max())
        if d_path > path_atol:
            path_bad.append(f"user {u}: |maintained - path fit| = "
                            f"{d_path:.2e} > {path_atol:.0e}")
        # (b) against the canonical retained-only fit the divergence is
        # bounded by the derived envelope E_u (DESIGN.md §11.2)
        canon_sizes = default_group_sizes(len(retained),
                                          params.group_size)
        v_canon = user_vector_ragged(retained, canon_sizes, params)
        canon[u] = v_canon.astype(np.float32)
        env = divergence_envelope(sizes, canon_sizes, params.r_b,
                                  params.r_g)
        d_canon = float(np.abs(v_m - v_canon).max())
        slack = d_canon - (env + path_atol)
        worst_slack = max(worst_slack, slack)
        if slack > 0:
            env_bad.append(f"user {u}: |maintained - canonical| = "
                           f"{d_canon:.2e} > envelope {env:.2e} + "
                           f"{path_atol:.0e}")
    checks = [
        CheckResult("path-fit", not path_bad,
                    path_bad[0] if path_bad else
                    f"{len(deletion_users)} deletion-bearing user(s) "
                    f"within {path_atol:.0e} of the retained path fit"),
        CheckResult("canonical-envelope", not env_bad,
                    env_bad[0] if env_bad else
                    f"max envelope slack {worst_slack:.2e} (<= 0 is "
                    "inside the derived bound)"),
    ]
    return checks, worst_slack, canon


def _overlap_check(leaves, canon, params, topn, overlap_floor,
                   device) -> Tuple[CheckResult, float]:
    """Top-n agreement between maintained and canonical serving.

    Each corpus's active rows go to ``device`` and every active user is
    served in one ``knn.recommend_for_users`` call (self-excluded k
    nearest, blended by alpha, top n, ties to the lowest index).
    """
    active = np.nonzero(leaves["n_baskets"] > 0)[0]
    if active.size < 2:
        return (CheckResult("topn-overlap", True,
                            "fewer than 2 active users"), 1.0)
    k = min(params.k_neighbors, active.size - 1)
    uid = torch.arange(active.size, device=device)

    def _topn(corpus):
        sub = torch.from_numpy(np.ascontiguousarray(corpus[active])) \
            .to(device)
        return knn.recommend_for_users(sub, uid, k=k, alpha=params.alpha,
                                       topn=topn).cpu().numpy()

    recs_m = _topn(leaves["corpus"])
    recs_c = _topn(canon)
    overlaps = [len(set(a.tolist()) & set(b.tolist())) / topn
                for a, b in zip(recs_m, recs_c)]
    mean = float(np.mean(overlaps))
    return (CheckResult(
        "topn-overlap", mean >= overlap_floor,
        f"mean top-{topn} overlap {mean:.3f} vs floor "
        f"{overlap_floor:.2f} over {active.size} active user(s)"),
        mean)


def _no_trace_checks(engine, hist, leaves, forgotten,
                     checkpoint_dir) -> List[CheckResult]:
    """A forgotten user leaves no residue in any live/persisted artifact."""
    checks: List[CheckResult] = []
    bad: List[str] = []
    for u in forgotten:
        if hist[u]:
            bad.append(f"user {u}: event log retains {len(hist[u])} "
                       "basket(s) — deletion sequence incomplete")
        if int(leaves["n_baskets"][u]) or int(leaves["n_groups"][u]):
            bad.append(f"user {u}: bookkeeping not empty")
        if (leaves["history"][u] >= 0).any():
            bad.append(f"user {u}: history rows hold item ids")
        for name in ("user_vecs", "last_group_vecs", "corpus"):
            r = float(np.abs(leaves[name][u]).max())
            if r != 0.0:
                bad.append(f"user {u}: {name} residue |max| = {r:.2e}")
    # serving-cache + frozen-snapshot residue via the store helper
    for sh, gids in _engines(engine):
        local = [int(np.nonzero(gids == u)[0][0]) for u in forgotten
                 if u in gids]
        if not local:
            continue
        residue = sh.store.row_residue(local)
        for key, val in residue.items():
            if val != 0.0 and key not in ("user_vec_absmax",
                                          "last_group_absmax",
                                          "history_ids", "n_baskets",
                                          "n_groups"):
                bad.append(f"shard store: {key} residue {val:.2e} for "
                           f"local rows {local}")
    dl = _dead_letter_users(engine)
    for u in forgotten:
        if u in dl:
            bad.append(f"user {u}: event(s) still in a dead-letter "
                       "queue")
    checks.append(CheckResult(
        "no-trace-live", not bad,
        bad[0] if bad else f"{len(forgotten)} forgotten user(s) leave "
        "no live residue"))
    if checkpoint_dir is not None:
        checks.append(_checkpoint_round_trip_check(
            engine, forgotten, checkpoint_dir))
    return checks


def _checkpoint_round_trip_check(engine, forgotten,
                                 directory) -> CheckResult:
    """Save -> reload from disk: persisted leaves hold no residue.

    The commit is flushed first when the engine writes in the
    background, so the read finds it.
    """
    engine.checkpoint(directory, step=1)
    engine.flush_checkpoints()
    bad: List[str] = []
    for s, (sh, gids) in enumerate(_engines(engine)):
        d = directory if isinstance(engine, StreamingEngine) \
            else os.path.join(directory, f"shard_{s:03d}")
        meta, leaves = load_checkpoint_arrays(d)
        for u in forgotten:
            hit = np.nonzero(gids == u)[0]
            if not hit.size:
                continue
            r = int(hit[0])
            for name in ("user_vecs", "last_group_vecs"):
                resid = float(np.abs(leaves[name][r]).max())
                if resid != 0.0:
                    bad.append(f"user {u}: persisted {name} residue "
                               f"{resid:.2e}")
            if (leaves["history"][r] >= 0).any() \
                    or int(leaves["n_baskets"][r]):
                bad.append(f"user {u}: persisted history not empty")
        # the persisted exactly-once log must carry only seqnos — any
        # event payload in the commit metadata would be residue
        eng_meta = meta.get("engine", {})
        extra = set(eng_meta) - {"watermark", "processed_above",
                                 "delivered", "next_seqno"}
        if extra:
            bad.append(f"commit metadata carries unexpected log "
                       f"fields {sorted(extra)}")
    return CheckResult(
        "checkpoint-round-trip", not bad,
        bad[0] if bad else "persisted commit holds no forgotten-user "
        "residue")


def certify(engine, events: Sequence[Event], *,
            params: Optional[TifuParams] = None,
            forgotten_users: Sequence[int] = (),
            topn: int = 5,
            overlap_floor: float = 0.5,
            path_atol: float = DEFAULT_PATH_ATOL,
            checkpoint_dir: Optional[str] = None) -> ComplianceReport:
    """Certify ``engine`` against its event log (DESIGN.md §11).

    ``events`` is the as-delivered log in order (quarantined deletions
    are re-derived by the same apply-time guards, so passing them is
    harmless); ``forgotten_users`` are global user ids whose entire
    history the log deletes (e.g. via ``forget_user``) -- they
    additionally get the no-trace checks, including a checkpoint round
    trip when ``checkpoint_dir`` is given.  Returns a
    :class:`ComplianceReport`; a deliberately skipped (or phantom)
    deletion fails the structural check, so tampering is detectable.
    Cost: one semantic log replay, one host copy of every leaf, one
    fresh replay of the pure-add users on the engine's device,
    O(deletion users · history) closed-form fits, and two serving calls
    over the active users.
    """
    params = engine.params if params is None else params
    n = _n_users(engine)
    events = list(events)
    hist = retained_histories(events, n)
    leaves = _global_leaves(engine)

    deletion_users = sorted(
        {ev.user for ev in events
         if ev.kind in (KIND_DEL_BASKET, KIND_DEL_ITEM)}
        | set(int(u) for u in forgotten_users))
    touched = {ev.user for ev in events}
    pure_add = sorted(touched - set(deletion_users))
    n_del = sum(ev.kind in (KIND_DEL_BASKET, KIND_DEL_ITEM)
                for ev in events)

    checks = [_structural_check(hist, leaves),
              _pure_add_bitwise_check(engine, events, pure_add, leaves,
                                      params)]
    del_checks, slack, canon = _deletion_checks(
        hist, leaves, deletion_users, params, path_atol)
    checks.extend(del_checks)
    overlap_check, overlap_mean = _overlap_check(
        leaves, canon, params, topn, overlap_floor,
        _first_store(engine).device)
    checks.append(overlap_check)
    if forgotten_users:
        checks.extend(_no_trace_checks(
            engine, hist, leaves, [int(u) for u in forgotten_users],
            checkpoint_dir))
    return ComplianceReport(
        n_users=n, n_events=len(events), n_deletion_events=n_del,
        pure_add_users=pure_add, deletion_users=deletion_users,
        forgotten_users=sorted(int(u) for u in forgotten_users),
        checks=checks, envelope_slack=slack, overlap_mean=overlap_mean)
