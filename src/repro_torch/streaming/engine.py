"""Micro-batch streaming engine — Algorithm 1 of the paper on one shard.

  * Incoming events (basket additions, basket/item deletions) are
    buffered in per-user queues and cut into micro-batches of at most
    one event per user, preserving per-user order while independent
    users update in parallel.
  * Each micro-batch is partitioned by kind into homogeneous
    ``AddBatch`` / ``DelBasketBatch`` / ``DelItemBatch`` sub-batches,
    padded to pow2 buckets with shrink hysteresis, and applied by the
    sparse appliers of ``core.updates``.
  * An exactly-once log (seqnos + watermark under subsequence
    semantics) makes redeliveries no-ops.
  * Everything the host learns from the device per step — the previous
    batch's maintenance probe and dropped-add count, the delete rows'
    basket counts — comes back in ONE transfer (``metrics.host_fetches``);
    maintenance for batch N runs at the start of step N+1.
  * ``checkpoint`` commits the state and the exactly-once log in one
    atomic ``LATEST`` write (synchronously, or through an
    ``AsyncCheckpointer``); ``restore`` installs a commit of either
    package, after which an at-least-once replay with the original
    seqnos converges to the fault-free state.  ``freeze_serving`` keeps
    ``recommend`` answering from a pinned snapshot meanwhile.

The JAX engine's tile hints are not ported: they only size Pallas grids,
and the CUDA kernels take no static grid bound.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import os
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core import knn, stability
from repro_torch.core.types import (KIND_ADD_BASKET, KIND_DEL_BASKET,
                                    KIND_DEL_ITEM, PAD_ID, AddBatch,
                                    DelBasketBatch, DelItemBatch,
                                    TifuParams, _pow2_pad)
from repro_torch.core.updates import (SCALE_CEIL, SCALE_FLOOR,
                                      apply_add_batch_counted,
                                      apply_del_basket_batch,
                                      apply_del_item_batch, refresh_users,
                                      renormalize_users)
from repro_torch.streaming.async_checkpoint import AsyncCheckpointer
from repro_torch.streaming.state_store import StateStore


def _maintenance_probe(st) -> torch.Tensor:
    """(err_max, scale_min, scale_max) as one device tensor f32[3]."""
    return torch.stack([st.err_mult.max(),
                        torch.minimum(st.uv_scale.min(), st.lgv_scale.min()),
                        torch.maximum(st.uv_scale.max(),
                                      st.lgv_scale.max())])


class InvalidEventError(ValueError):
    """A malformed event was rejected at submit time."""

    def __init__(self, event, reason: str):
        super().__init__(f"invalid event {event!r}: {reason}")
        self.event = event
        self.reason = reason


class Backpressure(RuntimeError):
    """Submit crossed the pending-queue high-water mark.

    A PREFIX of the call's events was admitted (``admitted``); the rest
    (``rejected``) were never assigned seqnos and must be resent.
    """

    def __init__(self, admitted: int, rejected: int,
                 first_rejected_seqno: Optional[int] = None,
                 pending: int = 0):
        super().__init__(
            f"pending queues at high-water mark ({pending} buffered): "
            f"admitted {admitted}, rejected {rejected} event(s)"
            + (f" from seqno {first_rejected_seqno}"
               if first_rejected_seqno is not None else ""))
        self.admitted = admitted
        self.rejected = rejected
        self.first_rejected_seqno = first_rejected_seqno
        self.pending = pending


@dataclasses.dataclass
class AdmissionResult:
    """What one ``submit`` call did with its events."""

    admitted: int = 0
    deduped: int = 0
    quarantined: int = 0
    rejected: int = 0
    first_rejected_seqno: Optional[int] = None


def _pad_request(user_ids) -> tuple:
    """Pad a serving request to its pow2 bucket, repeating the first id.

    Returns ``(padded_ids i64[bucket], q_n, bucket)``.
    """
    ids = np.asarray(user_ids, np.int64).ravel()
    q_n = ids.size
    if q_n == 0:
        return ids, 0, 0
    bucket = _pow2_pad(q_n)
    if bucket > q_n:
        ids = np.concatenate([ids, np.full(bucket - q_n, ids[0], ids.dtype)])
    return ids, q_n, bucket


@dataclasses.dataclass(frozen=True)
class Event:
    """One streaming event. ``seqno`` is assigned by the engine.

    Field-compatible with ``repro.streaming.engine.Event``.
    """

    kind: int
    user: int
    items: Optional[np.ndarray] = None   # for adds
    pos: int = 0                         # for deletes
    item: int = PAD_ID                   # for item deletes
    seqno: int = -1


@dataclasses.dataclass
class EngineMetrics:
    """Counters one engine accumulates (observability only)."""

    events_processed: int = 0
    batches: int = 0
    refreshes: int = 0
    renormalizations: int = 0
    dropped_adds: int = 0          # adds masked by the capacity guard
    dedup_skips: int = 0           # explicit-seqno redeliveries skipped
    bucket_grows: int = 0
    bucket_shrinks: int = 0
    last_batch_seconds: float = 0.0
    serve_requests: int = 0
    # device→host transfers of the step path: one per micro-batch, plus
    # one per triggered maintenance slow path
    host_fetches: int = 0
    dead_letters: int = 0
    backpressure_rejections: int = 0


class StreamingEngine:
    """Joint incremental/decremental state maintenance (Algorithm 1)."""

    def __init__(self, store: StateStore, params: TifuParams,
                 batch_size: int = 256,
                 stability_target_rel_err: Optional[float] = 1e-2,
                 bucket_hysteresis: int = 8,
                 max_pending: Optional[int] = None,
                 dead_letter_cap: int = 1024,
                 checkpointer: Optional[AsyncCheckpointer] = None):
        self.store = store
        self.params = params
        self.batch_size = batch_size
        # with a background writer, checkpoint() snapshots on the
        # caller's thread and commits on the writer's; None commits
        # inline
        self.checkpointer = checkpointer
        self.max_pending = max_pending
        self.dead_letter: deque = deque(maxlen=max(1, dead_letter_cap))
        self.bucket_hysteresis = max(1, bucket_hysteresis)
        self._kind_bucket: Dict[int, int] = {}
        self._below_bucket: Dict[int, int] = {}
        # the exactly-once log, the pending queues and the deferred
        # step summary, all empty
        self._reset_log()
        self.metrics = EngineMetrics()
        self.err_threshold = (
            stability.refresh_threshold(stability_target_rel_err)
            if stability_target_rel_err is not None else None)

    # -- ingestion ----------------------------------------------------------

    @property
    def n_pending(self) -> int:
        """Number of buffered (not yet applied) events."""
        return self._n_pending

    def _enqueue(self, ev) -> None:
        q = self._queues.get(ev.user)
        if q is None:
            q = self._queues[ev.user] = deque()
            heapq.heappush(self._heap, (ev.seqno, ev.user))
        q.append(ev)
        self._pending_seqnos.add(ev.seqno)
        self._n_pending += 1

    def _invalid_reason(self, ev) -> Optional[str]:
        """Why ``ev`` is statically malformed, or None."""
        cfg = self.store.cfg
        if ev.kind not in (KIND_ADD_BASKET, KIND_DEL_BASKET, KIND_DEL_ITEM):
            return f"unknown event kind {ev.kind}"
        if not 0 <= ev.user < cfg.n_users:
            return f"user {ev.user} outside [0, {cfg.n_users})"
        if ev.kind == KIND_ADD_BASKET:
            items = np.asarray(
                [] if ev.items is None else ev.items, np.int64).ravel()
            if items.size == 0:
                return "add-basket event with no items"
            if items.size > cfg.max_basket_size:
                return (f"basket of {items.size} items exceeds "
                        f"max_basket_size {cfg.max_basket_size}")
            bad = items[(items < 0) | (items >= cfg.n_items)]
            if bad.size:
                return f"item id {int(bad[0])} outside [0, {cfg.n_items})"
            return None
        if not 0 <= ev.pos < cfg.max_baskets:
            return (f"delete position {ev.pos} outside "
                    f"[0, {cfg.max_baskets})")
        if ev.kind == KIND_DEL_ITEM and not 0 <= ev.item < cfg.n_items:
            return f"item id {ev.item} outside [0, {cfg.n_items})"
        return None

    def _quarantine(self, ev, reason: str) -> None:
        self.dead_letter.append((ev, reason))
        self.metrics.dead_letters += 1

    def _would_shed(self, seqno: Optional[int] = None) -> bool:
        if self._shed_from is not None and (seqno is None
                                            or seqno > self._shed_from):
            return True
        return (self.max_pending is not None
                and self._n_pending >= self.max_pending)

    def submit(self, events: Iterable, *, on_invalid: str = "raise",
               on_overflow: str = "raise") -> AdmissionResult:
        """Enqueue events: dedup, validate, admit under backpressure.

        Per event: explicit-seqno redeliveries already processed or
        buffered are skipped (exactly-once); malformed events raise
        :class:`InvalidEventError` or, with ``on_invalid="quarantine"``,
        go to the dead-letter queue (consuming their seqno); past
        ``max_pending`` events are shed (``on_overflow="raise"`` raises
        :class:`Backpressure` after the admitted prefix is enqueued).
        O(1) amortized per event.
        """
        if on_invalid not in ("raise", "quarantine"):
            raise ValueError(f"on_invalid={on_invalid!r}")
        if on_overflow not in ("raise", "shed"):
            raise ValueError(f"on_overflow={on_overflow!r}")
        res = AdmissionResult()
        for ev in events:
            explicit = ev.seqno >= 0
            if explicit and (ev.seqno <= self.watermark
                             or ev.seqno in self._processed_above
                             or ev.seqno in self._pending_seqnos):
                self.metrics.dedup_skips += 1
                res.deduped += 1
                continue
            reason = self._invalid_reason(ev)
            if reason is not None:
                if on_invalid == "raise":
                    raise InvalidEventError(ev, reason)
                if not explicit:
                    ev = dataclasses.replace(ev, seqno=self._next_seqno)
                    self._next_seqno += 1
                else:
                    self._next_seqno = max(self._next_seqno, ev.seqno + 1)
                self._max_delivered = max(self._max_delivered, ev.seqno)
                self._processed_above.add(ev.seqno)
                self._advance_watermark()
                self._quarantine(ev, reason)
                res.quarantined += 1
                continue
            if self._would_shed(ev.seqno if explicit else None):
                self.metrics.backpressure_rejections += 1
                res.rejected += 1
                if explicit:
                    if (res.first_rejected_seqno is None
                            or ev.seqno < res.first_rejected_seqno):
                        res.first_rejected_seqno = ev.seqno
                    if self._shed_from is None or ev.seqno < self._shed_from:
                        self._shed_from = ev.seqno
                continue
            if not explicit:
                ev = dataclasses.replace(ev, seqno=self._next_seqno)
                self._next_seqno += 1
            else:
                self._next_seqno = max(self._next_seqno, ev.seqno + 1)
                if ev.seqno == self._shed_from:
                    self._shed_from = None
            self._max_delivered = max(self._max_delivered, ev.seqno)
            self._enqueue(ev)
            res.admitted += 1
        if res.rejected and on_overflow == "raise":
            raise Backpressure(res.admitted, res.rejected,
                               res.first_rejected_seqno, self._n_pending)
        return res

    # -- micro-batch processing ---------------------------------------------

    def _cut_batch(self) -> List:
        """Take up to batch_size events in seqno order, one per user."""
        taken: List = []
        requeue = []
        while self._heap and len(taken) < self.batch_size:
            _, user = heapq.heappop(self._heap)
            q = self._queues[user]
            taken.append(q.popleft())
            if q:
                requeue.append((q[0].seqno, user))
            else:
                del self._queues[user]
        for entry in requeue:
            heapq.heappush(self._heap, entry)
        for ev in taken:
            self._pending_seqnos.discard(ev.seqno)
        self._n_pending -= len(taken)
        return taken

    def _bucket(self, kind: int, n: int) -> int:
        """Pick the padded sub-batch size for ``n`` rows of ``kind``.

        Growth is immediate; a shrink waits for ``bucket_hysteresis``
        consecutive micro-batches that fit the smaller bucket.
        """
        want = _pow2_pad(n, self.batch_size)
        cur = self._kind_bucket.get(kind, 0)
        if want >= cur:
            if want > cur and cur:
                self.metrics.bucket_grows += 1
            self._kind_bucket[kind] = want
            self._below_bucket[kind] = 0
            return want
        self._below_bucket[kind] = self._below_bucket.get(kind, 0) + 1
        if self._below_bucket[kind] >= self.bucket_hysteresis:
            self._kind_bucket[kind] = want
            self._below_bucket[kind] = 0
            self.metrics.bucket_shrinks += 1
            return want
        return cur

    def _decay_absent_buckets(self, present) -> None:
        """Advance the shrink hysteresis of kinds absent from a batch.

        An absent kind counts as a zero-row batch, so a one-off burst
        does not pin its bucket.
        """
        for kind in list(self._kind_bucket):
            if kind not in present and self._kind_bucket[kind] > 1:
                self._bucket(kind, 0)

    def _fetch(self, parts: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """The step path's device→host read: ONE counted transfer.

        The parts are packed into one float64 tensor (exact for the f32
        and int32 values here), copied once, and unpacked on the host.
        """
        self.metrics.host_fetches += 1
        names = list(parts)
        flat = [parts[n].reshape(-1).to(torch.float64) for n in names]
        host = torch.cat(flat).cpu().numpy()
        out, at = {}, 0
        for name, f in zip(names, flat):
            out[name] = host[at:at + f.numel()]
            at += f.numel()
        return out

    def _poison_filter(self, delb, deli, nb):
        """Quarantine deletes whose position is beyond the CURRENT history.

        The applier's clip would otherwise delete the wrong basket.
        """
        keep_b: List = []
        keep_i: List = []
        for ev, n in zip(delb + deli, nb):
            if ev.pos >= int(n):
                self._quarantine(
                    ev, f"delete position {ev.pos} beyond user "
                        f"{ev.user}'s history of {int(n)} basket(s)")
            elif ev.kind == KIND_DEL_BASKET:
                keep_b.append(ev)
            else:
                keep_i.append(ev)
        return keep_b, keep_i

    def _apply_sub_batches(self, adds, delb, deli) -> None:
        """Apply one micro-batch's kind sub-batches (disjoint users)."""
        self._decay_absent_buckets({kind for kind, evs in
                                    ((KIND_ADD_BASKET, adds),
                                     (KIND_DEL_BASKET, delb),
                                     (KIND_DEL_ITEM, deli)) if evs})
        dev = self.store.device
        b = self.store.cfg.max_basket_size
        if adds:
            batch = AddBatch.build(
                [ev.user for ev in adds], [ev.items for ev in adds], b,
                pad_to=self._bucket(KIND_ADD_BASKET, len(adds)), device=dev)
            # the drop count accumulates on the device and rides the next
            # step's single fetch
            _, dropped = apply_add_batch_counted(self.store.state, batch,
                                                 self.params)
            self._dropped_dev = (dropped if self._dropped_dev is None
                                 else self._dropped_dev + dropped)
        if delb:
            batch = DelBasketBatch.build(
                [ev.user for ev in delb], [ev.pos for ev in delb],
                pad_to=self._bucket(KIND_DEL_BASKET, len(delb)), device=dev)
            apply_del_basket_batch(self.store.state, batch, self.params)
        if deli:
            batch = DelItemBatch.build(
                [ev.user for ev in deli], [ev.pos for ev in deli],
                [ev.item for ev in deli],
                pad_to=self._bucket(KIND_DEL_ITEM, len(deli)), device=dev)
            apply_del_item_batch(self.store.state, batch, self.params)
        self.store.invalidate_users([ev.user for ev in adds + delb + deli])

    def _apply_maintenance(self, err_max: float, lo: float,
                           hi: float) -> None:
        """Stability refreshes + scale renormalization from the probe.

        The healthy path costs nothing beyond the probe scalars; each
        triggered path pays one extra counted fetch to find its rows.
        """
        st = self.store.state
        if self.err_threshold is not None and err_max > self.err_threshold:
            err = self._fetch({"err": st.err_mult})["err"]
            bad = np.nonzero(err > self.err_threshold)[0]
            if bad.size:
                refresh_users(st, torch.as_tensor(bad, device=st.device),
                              self.params)
                self.metrics.refreshes += int(bad.size)
                self.store.invalidate_users(bad)
        floor = SCALE_FLOOR * 1e2   # renormalize well before the bounds
        ceil = SCALE_CEIL * 1e-2
        if lo < floor or hi > ceil:
            h = self._fetch({"uv": st.uv_scale, "lgv": st.lgv_scale})
            out = np.nonzero((h["uv"] < floor) | (h["lgv"] < floor)
                             | (h["uv"] > ceil) | (h["lgv"] > ceil))[0]
            renormalize_users(st, torch.as_tensor(out, device=st.device))
            self.metrics.renormalizations += int(out.size)

    def _summary_parts(self) -> Dict[str, torch.Tensor]:
        parts: Dict[str, torch.Tensor] = {}
        if self._maintenance_due:
            parts["probe"] = _maintenance_probe(self.store.state)
        if self._dropped_dev is not None:
            parts["dropped"] = self._dropped_dev
        return parts

    def _consume_summary(self, host: Dict[str, np.ndarray]) -> None:
        if "dropped" in host:
            self.metrics.dropped_adds += int(host["dropped"][0])
            self._dropped_dev = None
        if "probe" in host:
            self._apply_maintenance(*(float(x) for x in host["probe"]))
            self._maintenance_due = False

    def _flush_deferred(self) -> None:
        """Settle the deferred maintenance probe and drop count now.

        A drain ends on the empty step, whose fetch carries the last
        batch's summary; a checkpoint may come before that step, so it
        settles the summary here: one counted fetch when something is
        due, none otherwise.
        """
        parts = self._summary_parts()
        if parts:
            self._consume_summary(self._fetch(parts))

    def step(self) -> int:
        """Process one micro-batch. Returns the number of events applied.

        The previous batch's deferred maintenance probe and drop count
        and this batch's delete-row basket counts come back in one
        transfer; maintenance runs before this batch's appliers, which
        reproduces the trajectory apply_N → maintain → apply_N+1.
        """
        t0 = time.perf_counter()
        events = self._cut_batch()
        adds = [ev for ev in events if ev.kind == KIND_ADD_BASKET]
        delb = [ev for ev in events if ev.kind == KIND_DEL_BASKET]
        deli = [ev for ev in events if ev.kind == KIND_DEL_ITEM]
        parts = self._summary_parts()
        if delb or deli:
            idx = torch.as_tensor([ev.user for ev in delb + deli],
                                  device=self.store.device)
            parts["del_nb"] = self.store.state.n_baskets[idx]
        host = self._fetch(parts) if parts else {}
        self._consume_summary(host)
        if not events:
            return 0
        if "del_nb" in host:
            delb, deli = self._poison_filter(delb, deli, host["del_nb"])
        self._apply_sub_batches(adds, delb, deli)
        self._maintenance_due = True
        for ev in events:
            self._processed_above.add(ev.seqno)
        self._advance_watermark()
        self.metrics.events_processed += len(events)
        self.metrics.batches += 1
        self.metrics.last_batch_seconds = time.perf_counter() - t0
        return len(events)

    def _advance_watermark(self) -> None:
        """Advance the watermark under the subsequence semantics.

        It passes seqnos processed here or never delivered here; pending
        seqnos and anything beyond the last delivery block.
        """
        nxt = self.watermark + 1
        while nxt <= self._max_delivered and nxt not in self._pending_seqnos:
            self._processed_above.discard(nxt)
            self.watermark = nxt
            nxt += 1

    def run_until_drained(self, max_batches: int = 10_000) -> int:
        """Step until the pending queues empty; returns events applied.

        Ends on the empty step, whose fetch settles the last batch's
        deferred maintenance.
        """
        total = 0
        for _ in range(max_batches):
            n = self.step()
            if n == 0:
                break
            total += n
        return total

    # -- serving ------------------------------------------------------------

    def recommend(self, user_ids, topn: int = 10, k: Optional[int] = None,
                  alpha: Optional[float] = None,
                  metric: str = "euclidean",
                  quantized: bool = False) -> np.ndarray:
        """Top-n recommendations for ``user_ids`` from the cached corpus.

        The request is padded to a pow2 bucket (repeating the first
        user; the padding rows are computed and dropped) and served
        through ``core.knn.recommend_for_users``.  ``quantized=True``
        serves the int8 path instead: the ``StateStore.quantized_corpus()``
        cache (row-invalidated alongside the fp32 one) through
        ``core.knn.recommend_for_users_quant``, euclidean only.  Returns
        i32[Q, topn].
        """
        ids, q_n, _ = _pad_request(user_ids)
        if q_n == 0:
            return np.zeros((0, topn), np.int32)
        k = self.params.k_neighbors if k is None else k
        alpha = self.params.alpha if alpha is None else alpha
        uid = torch.as_tensor(ids, device=self.store.device)
        if quantized:
            if metric != "euclidean":
                raise ValueError("quantized serving is euclidean-only")
            corpus_q, c_scale = self.store.quantized_corpus()
            recs = knn.recommend_for_users_quant(corpus_q, c_scale, uid,
                                                 k=k, alpha=alpha, topn=topn)
        else:
            recs = knn.recommend_for_users(self.store.corpus(), uid, k=k,
                                           alpha=alpha, topn=topn,
                                           metric=metric)
        self.metrics.serve_requests += 1
        return recs.cpu().numpy()[:q_n]

    # -- degraded serving ---------------------------------------------------

    def freeze_serving(self) -> None:
        """Enter degraded serving: pin the current corpus snapshot.

        ``recommend`` keeps answering (fp32 and int8) from the pinned
        snapshot while the live state moves on or is restored; answers
        are stale but well-formed.  Idempotent.
        """
        self.store.freeze_serving()

    def thaw_serving(self) -> None:
        """Leave degraded serving; ``recommend`` reads live state again."""
        self.store.thaw_serving()

    @property
    def serving_degraded(self) -> bool:
        """True while ``recommend`` answers from a pinned stale snapshot."""
        return self.store.serving_degraded

    # -- recovery -----------------------------------------------------------

    def checkpoint(self, directory: str, step: int) -> None:
        """Commit state + exactly-once log atomically.

        The log rides inside the store's ``LATEST`` metadata, the
        checkpoint's single atomic commit point, so a crash anywhere can
        never pair a new state with an old log.  Deferred maintenance is
        settled first (:meth:`_flush_deferred`), so the committed state
        matches the drained trajectory.  With a ``checkpointer`` the
        caller-thread cost is one host snapshot copy and the commit runs
        on the writer thread; its failures surface at the next
        ``checkpoint`` / :meth:`flush_checkpoints` / :meth:`restore`.
        Without one: one O(state) snapshot + inline write.
        """
        self._flush_deferred()
        extra = {"engine": {
            "watermark": self.watermark,
            "processed_above": sorted(self._processed_above),
            "delivered": self._max_delivered,
            "next_seqno": self._next_seqno}}
        if self.checkpointer is not None:
            self.store.checkpoint_async(self.checkpointer, directory,
                                        step, extra_meta=extra)
        else:
            self.store.checkpoint(directory, step, extra_meta=extra)

    def flush_checkpoints(self) -> None:
        """Block until every async commit landed (no-op when sync).

        Re-raises the writer thread's first error: the synchronization
        point a caller must cross before trusting that a
        :meth:`checkpoint` call's commit exists on disk.
        """
        if self.checkpointer is not None:
            self.checkpointer.flush()

    def restore(self, directory: str) -> None:
        """Install a checkpoint: state, serving caches, exactly-once log.

        Pending async commits are flushed first (restore never races
        its own writer, and a recorded writer crash re-raises here).
        The pending queues and the deferred step summary are dropped
        (they were never part of the commit); an at-least-once source
        replays the stream WITH THE ORIGINAL seqnos and :meth:`submit`
        skips everything the restored log covers.  A commit without an
        ``engine`` log reads the legacy ``ENGINE`` file beside it.
        Cost: one O(state) read + host-to-device copy.
        """
        self.flush_checkpoints()
        self.store.restore(directory)
        meta = self.store.last_restored_meta.get("engine")
        if meta is None:
            with open(os.path.join(directory, "ENGINE")) as f:
                meta = json.load(f)
        self._reset_log()
        self._load_log(meta)

    def _load_log(self, meta: dict) -> None:
        """Install a persisted exactly-once log (see :meth:`checkpoint`)."""
        self.watermark = meta["watermark"]
        self._processed_above = set(meta.get("processed_above", []))
        self._next_seqno = meta["next_seqno"]
        # legacy checkpoints lack `delivered`; they were written by dense
        # single engines, where every seqno below next_seqno was delivered
        self._max_delivered = meta.get("delivered", meta["next_seqno"] - 1)

    def _reset_log(self) -> None:
        """A fresh empty log, no pending events, nothing deferred."""
        self.watermark = -1
        self._processed_above: set = set()
        self._pending_seqnos: set = set()
        self._max_delivered = -1
        self._next_seqno = 0
        self._queues: Dict[int, deque] = {}
        self._heap: List[tuple] = []
        self._n_pending = 0
        # first shed explicit seqno not yet readmitted: later first
        # deliveries keep shedding until it is (no gap below the log);
        # dropped queues drop the gap too, the source replays the log
        self._shed_from: Optional[int] = None
        self._maintenance_due = False
        self._dropped_dev: Optional[torch.Tensor] = None
