"""Micro-batch streaming engine (Algorithm 1 of the paper), and its shards.

The engine and its user-axis sharded deployment:

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
    maintenance for batch N runs at the start of step N+1.  A step has
    three phases: ``_prepare_step`` cuts the batch and dispatches the
    transfer without waiting, ``_complete_step`` waits for it and
    applies, ``_finish_step`` advances the log.
  * ``checkpoint`` commits the state and the exactly-once log in one
    atomic ``LATEST`` write (synchronously, or through an
    ``AsyncCheckpointer``); ``restore`` installs a commit of either
    package, after which an at-least-once replay with the original
    seqnos converges to the fault-free state.  ``freeze_serving`` keeps
    ``recommend`` answering from a pinned snapshot meanwhile.
  * ``forget_user`` (the GDPR front door) deletes a user's baskets
    through the exactly-once path, zeroes their rows in the state and
    the serving caches, purges their dead letters and returns a
    ``ForgetReceipt`` with the measured residue.
  * ``ShardedStreamingEngine`` routes events by user to independent
    engines, one per shard, runs their step phases in three passes so
    no shard's wait holds back another's dispatch, and checkpoints,
    restores and reshards them (N→M) in the JAX package's layout.

The JAX engine's tile hints are not ported: they only size Pallas grids,
and the CUDA kernels take no static grid bound.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import json
import os
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import knn, stability
from repro_torch.core.types import (KIND_ADD_BASKET, KIND_DEL_BASKET,
                                    KIND_DEL_ITEM, PAD_ID, AddBatch,
                                    DelBasketBatch, DelItemBatch,
                                    StreamState, TifuParams, _dev,
                                    _pow2_pad)
from repro_torch.core.updates import (SCALE_CEIL, SCALE_FLOOR,
                                      apply_add_batch_counted,
                                      apply_del_basket_batch,
                                      apply_del_item_batch, refresh_users,
                                      renormalize_users)
from repro_torch.parallel.sharding import UserShardSpec
from repro_torch.streaming.async_checkpoint import AsyncCheckpointer
from repro_torch.streaming.state_store import (CorruptCheckpointError,
                                               StateStore, StoreConfig,
                                               atomic_write_json,
                                               load_checkpoint_arrays,
                                               load_json_checked)


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

    def merge(self, other: "AdmissionResult") -> "AdmissionResult":
        """Fold another result in (the sharded router's aggregate)."""
        self.admitted += other.admitted
        self.deduped += other.deduped
        self.quarantined += other.quarantined
        self.rejected += other.rejected
        if other.first_rejected_seqno is not None and (
                self.first_rejected_seqno is None
                or other.first_rejected_seqno < self.first_rejected_seqno):
            self.first_rejected_seqno = other.first_rejected_seqno
        return self


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


@dataclasses.dataclass(frozen=True)
class ForgetReceipt:
    """Receipt of one ``forget_user`` call (the GDPR front door).

    ``seqnos`` are the deletion events emitted on the user's behalf (the
    audit trail tying the forget to the exactly-once log),
    ``purged_dead_letters`` the quarantined events of theirs that were
    dropped, ``latency_s`` the host-clock seconds of the whole call, and
    ``residue`` the post-scrub :meth:`StateStore.row_residue`
    measurement -- ``clean`` is True iff every artifact reads zero.  The
    full certificate is ``repro_torch.compliance.certify`` over the
    event log.
    """

    user: int
    n_baskets_deleted: int
    seqnos: tuple
    purged_dead_letters: int
    latency_s: float
    residue: dict

    @property
    def clean(self) -> bool:
        """True iff no live artifact still holds the user's data."""
        return all(v == 0.0 for v in self.residue.values())


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


class _HostFetch:
    """One device→host read in flight: named parts, copied as one.

    The parts are packed into one float64 tensor (exact for the f32 and
    int32 values here).  On CUDA it is copied with ``non_blocking`` into
    pinned host memory and a CUDA event is recorded behind the copy, so
    the caller goes on queueing work; :meth:`wait` synchronizes on the
    event alone, not on the work queued after it.  On the CPU the packed
    tensor is already the host copy.
    """

    def __init__(self, parts: Dict[str, torch.Tensor]) -> None:
        flat = [t.reshape(-1).to(torch.float64) for t in parts.values()]
        self._sizes = [(name, f.numel()) for name, f in zip(parts, flat)]
        packed = torch.cat(flat)
        self._done: Optional[torch.cuda.Event] = None
        if packed.device.type == "cuda":
            self._host = torch.empty(packed.shape, dtype=packed.dtype,
                                     pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(packed.device))
        else:
            self._host = packed

    def wait(self) -> Dict[str, np.ndarray]:
        """Block until the copy landed; the parts as host arrays."""
        if self._done is not None:
            self._done.synchronize()
        host = self._host.numpy()
        out, at = {}, 0
        for name, n in self._sizes:
            out[name] = host[at:at + n]
            at += n
        return out


def _delete_baskets(eng, user: int, nb: int) -> tuple:
    """Submit ``nb`` basket deletions for ``user`` and drain.

    Through ``eng``'s ``submit`` (a single engine or the router), last
    position first so every position stays valid; returns their seqnos.
    """
    first = eng._next_seqno
    if nb:
        eng.submit([Event(KIND_DEL_BASKET, user, pos=p)
                    for p in range(nb - 1, -1, -1)])
        eng.run_until_drained()
    return tuple(range(first, first + nb))


def _purge_user(dead_letter: deque, user: int) -> int:
    """Drop ``user``'s entries from a dead-letter queue; returns how many.

    In place: the queue keeps its ``maxlen``.
    """
    kept = [(ev, why) for ev, why in dead_letter if ev.user != user]
    purged = len(dead_letter) - len(kept)
    if purged:
        dead_letter.clear()
        dead_letter.extend(kept)
    return purged


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

    def add_basket(self, user: int, items: Sequence[int]) -> None:
        """Enqueue one basket addition (Eq. 7–9) for ``user``."""
        self.submit([Event(KIND_ADD_BASKET, user,
                           items=np.asarray(items, np.int32))])

    def delete_basket(self, user: int, pos: int) -> None:
        """Enqueue the deletion of basket ``pos`` (Eq. 10–12)."""
        self.submit([Event(KIND_DEL_BASKET, user, pos=pos)])

    def delete_item(self, user: int, pos: int, item: int) -> None:
        """Enqueue the deletion of ``item`` from basket ``pos`` (Eq. 13)."""
        self.submit([Event(KIND_DEL_ITEM, user, pos=pos, item=item)])

    # -- unlearning front door ----------------------------------------------

    def forget_user(self, user: int) -> ForgetReceipt:
        """Erase ``user``'s entire history and every live trace of it.

        Drains the pending queues (so the user's in-flight events land
        first), emits one ``KIND_DEL_BASKET`` per remaining basket --
        last position first -- through the normal exactly-once
        :meth:`submit`, then zeroes the row exactly, caches included
        (:meth:`_scrub_user`), and purges the user's dead letters
        (quarantined events carry payloads).  Synchronous: returns once
        the state is clean, with a :class:`ForgetReceipt` tying the
        emitted seqnos to the measured residue.  Cost: the user's
        O(n_baskets) deletion events plus one O(n_items) row scrub.
        Idempotent.  An out-of-range user raises
        :class:`InvalidEventError` (before any device read).
        """
        n_users = self.store.cfg.n_users
        if not 0 <= user < n_users:
            raise InvalidEventError(
                Event(KIND_DEL_BASKET, user),
                f"user {user} outside [0, {n_users})")
        t0 = time.perf_counter()
        self.run_until_drained()
        # one scalar read on the device, not the whole O(n_users) leaf
        nb = int(self.store.state.n_baskets[user])
        seqnos = _delete_baskets(self, user, nb)
        self._scrub_user(user)
        purged = self._purge_dead_letters(user)
        return ForgetReceipt(
            user=user, n_baskets_deleted=nb, seqnos=seqnos,
            purged_dead_letters=purged,
            latency_s=time.perf_counter() - t0,
            residue=self.store.row_residue([user]))

    def _scrub_user(self, user: int) -> None:
        """Zero a forgotten user's row exactly, caches included.

        Earlier item deletes can leave f32 dust at cells outside the
        final support; ``refresh_users`` on the now-empty history
        recomputes the row from the integer leaves alone (exact zeros,
        scales 1), and ``scrub_rows`` pushes the zeros into whichever
        serving caches exist.
        """
        refresh_users(self.store.state,
                      torch.tensor([user], device=self.store.device),
                      self.params)
        self.store.scrub_rows([user])

    def _purge_dead_letters(self, user: int) -> int:
        """Drop the user's quarantined events (they carry payloads)."""
        return _purge_user(self.dead_letter, user)

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

    def _fetch(self, parts: Dict[str, torch.Tensor]) -> "_HostFetch":
        """Dispatch the step path's device→host read: ONE counted transfer.

        Returns at once; ``.wait()`` on the result blocks until the copy
        landed and unpacks it (see :class:`_HostFetch`).
        """
        self.metrics.host_fetches += 1
        return _HostFetch(parts)

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
            err = self._fetch({"err": st.err_mult}).wait()["err"]
            bad = np.nonzero(err > self.err_threshold)[0]
            if bad.size:
                refresh_users(st, torch.as_tensor(bad, device=st.device),
                              self.params)
                self.metrics.refreshes += int(bad.size)
                self.store.invalidate_users(bad)
        floor = SCALE_FLOOR * 1e2   # renormalize well before the bounds
        ceil = SCALE_CEIL * 1e-2
        if lo < floor or hi > ceil:
            h = self._fetch({"uv": st.uv_scale,
                             "lgv": st.lgv_scale}).wait()
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
            self._consume_summary(self._fetch(parts).wait())

    def _prepare_step(self) -> tuple:
        """Cut a micro-batch and dispatch its step summary's fetch.

        The previous batch's deferred maintenance probe and drop count
        and this batch's delete-row basket counts are packed and copied
        to the host without waiting (:meth:`_fetch`), so a sharded
        deployment dispatches every shard's copy before any shard blocks
        on its own (``ShardedStreamingEngine.step``).
        """
        events = self._cut_batch()
        adds = [ev for ev in events if ev.kind == KIND_ADD_BASKET]
        delb = [ev for ev in events if ev.kind == KIND_DEL_BASKET]
        deli = [ev for ev in events if ev.kind == KIND_DEL_ITEM]
        parts = self._summary_parts()
        if delb or deli:
            idx = _dev(np.asarray([ev.user for ev in delb + deli],
                                  np.int64), self.store.device)
            parts["del_nb"] = self.store.state.n_baskets[idx]
        pending = self._fetch(parts) if parts else None
        return events, adds, delb, deli, pending

    def _complete_step(self, prep: tuple) -> List:
        """Wait for the step summary and apply the batch; returns it.

        Maintenance runs before this batch's appliers, which reproduces
        the trajectory apply_N → maintain → apply_N+1; the summary was
        taken before maintenance, which touches no integer leaf.
        """
        events, adds, delb, deli, pending = prep
        host = pending.wait() if pending is not None else {}
        self._consume_summary(host)
        if not events:
            return events
        if "del_nb" in host:
            delb, deli = self._poison_filter(delb, deli, host["del_nb"])
        self._apply_sub_batches(adds, delb, deli)
        self._maintenance_due = True
        return events

    def _finish_step(self, events: List, t0: float) -> int:
        """Advance the exactly-once log and the counters for one batch."""
        for ev in events:
            self._processed_above.add(ev.seqno)
        self._advance_watermark()
        self.metrics.events_processed += len(events)
        self.metrics.batches += 1
        self.metrics.last_batch_seconds = time.perf_counter() - t0
        return len(events)

    def step(self) -> int:
        """Process one micro-batch. Returns the number of events applied.

        The previous batch's deferred maintenance probe and drop count
        and this batch's delete-row basket counts come back in one
        transfer (:meth:`_prepare_step`, :meth:`_complete_step`).
        """
        t0 = time.perf_counter()
        events = self._complete_step(self._prepare_step())
        if not events:
            return 0
        return self._finish_step(events, t0)

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


# -- the user-axis sharded deployment ---------------------------------------

_SHARD_MANIFEST = "SHARDS"

# every StreamState leaf, derived so the resharding assembler cannot
# silently drop a new field
_STATE_LEAVES = tuple(f.name for f in dataclasses.fields(StreamState))


class ShardedStreamingEngine:
    """User-axis sharded streaming maintenance.

    The paper's Spark deployment partitions the keyed state by user;
    here ``n_shards`` independent :class:`StreamingEngine` instances each
    own a :class:`StateStore` (on its own device, see
    ``launch.mesh.make_user_shard_devices``), an exactly-once log, pow2
    sub-batch buckets and an atomic ``LATEST`` commit.  This router only
    (a) assigns global seqnos, (b) routes an event of global user ``u``
    to shard ``u % n_shards`` at local row ``u // n_shards``
    (:class:`repro_torch.parallel.sharding.UserShardSpec`), and (c)
    orchestrates cross-shard checkpoint, restore and serving.  No event
    crosses shards: each user's vector is computed independently.

    Exactly-once across shards: each shard's log keeps its watermark
    under SUBSEQUENCE semantics, so a crash between two shard commits
    restores shards at different steps and a replay of the whole stream
    re-applies exactly what each shard lost.  A reshard (an N-shard
    checkpoint restored into M shards) reassembles the global rows
    through the spec bijection and keeps the N old logs as legacy logs:
    a redelivered event is checked against the log of its OLD owner
    shard (``user % N``, known at submit time).

    Checkpoints use the JAX package's layout (``shard_{s:03d}/`` commits
    plus the ``SHARDS`` manifest), so either package restores the
    other's.
    """

    def __init__(self, stores: Sequence[StateStore], params: TifuParams,
                 spec: UserShardSpec, **engine_kw: Any) -> None:
        if len(stores) != spec.n_shards:
            raise ValueError(f"{len(stores)} stores for {spec.n_shards} "
                             "shards")
        for s, st in enumerate(stores):
            want = spec.shard_users(s)
            if st.cfg.n_users != want:
                raise ValueError(
                    f"shard {s}: store has {st.cfg.n_users} user rows, "
                    f"spec owns {want} (n_users={spec.n_users})")
        self.spec = spec
        self.params = params
        self.shards = [StreamingEngine(st, params, **engine_kw)
                       for st in stores]
        # one background writer for the whole deployment: FIFO, so the
        # SHARDS manifest job queued after the shard commits never lands
        # before them
        self.checkpointer: Optional[AsyncCheckpointer] = \
            engine_kw.get("checkpointer")
        self._next_seqno = 0
        # logs of earlier layouts after a reshard:
        # [{"n_shards": N_old, "logs": [{"watermark", "processed_above"}]}]
        self._legacy: List[dict] = []
        # events with no owner shard (global user out of range); the
        # shards' own dead letters hold the rest
        self.dead_letter: deque = deque(maxlen=1024)
        self.router_dead_letters = 0

    @classmethod
    def create(cls, spec: UserShardSpec, params: TifuParams,
               max_baskets: int, max_basket_size: int,
               max_groups: Optional[int] = None,
               devices: Optional[Sequence[Any]] = None,
               **engine_kw: Any) -> "ShardedStreamingEngine":
        """Build the per-shard stores from the spec and store shapes.

        ``devices`` is one device per shard
        (``launch.mesh.make_user_shard_devices``); None puts every shard
        on CUDA, which raises without a card.
        """
        stores = []
        for s in range(spec.n_shards):
            cfg = StoreConfig(n_users=spec.shard_users(s),
                              n_items=params.n_items,
                              max_baskets=max_baskets,
                              max_basket_size=max_basket_size,
                              max_groups=max_groups)
            stores.append(StateStore(
                cfg, device=None if devices is None else devices[s]))
        return cls(stores, params, spec, **engine_kw)

    # -- ingestion ----------------------------------------------------------

    @property
    def n_pending(self) -> int:
        """Buffered (not yet applied) events across all shards."""
        return sum(sh.n_pending for sh in self.shards)

    @property
    def events_processed(self) -> int:
        """Events applied across all shards."""
        return sum(sh.metrics.events_processed for sh in self.shards)

    @property
    def dead_letters(self) -> int:
        """Quarantined events, the router's and every shard's."""
        return (self.router_dead_letters
                + sum(sh.metrics.dead_letters for sh in self.shards))

    @property
    def backpressure_rejections(self) -> int:
        """Events shed by backpressure across all shards."""
        return sum(sh.metrics.backpressure_rejections
                   for sh in self.shards)

    def _legacy_processed(self, user: int, seqno: int) -> bool:
        """True when a layout before a reshard already processed seqno.

        The old owner shard of ``user`` follows from the old shard
        count, so this is an exact lookup in that shard's persisted log:
        O(#reshards) per event.
        """
        for entry in self._legacy:
            log = entry["logs"][user % entry["n_shards"]]
            if seqno <= log["watermark"] \
                    or seqno in log["processed_above"]:
                return True
        return False

    def submit(self, events: Iterable, *, on_invalid: str = "raise",
               on_overflow: str = "raise") -> AdmissionResult:
        """Assign global seqnos and route events to their owner shards.

        An explicit-seqno event (at-least-once redelivery) is checked
        against the legacy logs of earlier layouts, then against its
        owner shard's log (in the shard's ``submit``).  An event whose
        global user has no owner shard raises or is quarantined here
        (``self.dead_letter``); validation and backpressure happen in
        the owner shard and add up to one :class:`AdmissionResult` (or
        one :class:`Backpressure`, raised after the admissible events
        are enqueued).  A seqno-less event probes its owner shard BEFORE
        it is given a global seqno: a shed event was never delivered,
        and a burned seqno would be a permanent gap in the shard's log.
        """
        if on_invalid not in ("raise", "quarantine"):
            raise ValueError(f"on_invalid={on_invalid!r}")
        if on_overflow not in ("raise", "shed"):
            raise ValueError(f"on_overflow={on_overflow!r}")
        res = AdmissionResult()
        for ev in events:
            explicit = ev.seqno >= 0
            if explicit:
                self._next_seqno = max(self._next_seqno, ev.seqno + 1)
                if self._legacy and self._legacy_processed(ev.user,
                                                           ev.seqno):
                    res.deduped += 1
                    continue
            if not 0 <= ev.user < self.spec.n_users:
                reason = (f"user {ev.user} outside the deployment's "
                          f"[0, {self.spec.n_users}) global range")
                if on_invalid == "raise":
                    raise InvalidEventError(ev, reason)
                self.dead_letter.append((ev, reason))
                self.router_dead_letters += 1
                res.quarantined += 1
                continue
            sh = self.shards[self.spec.shard_of(ev.user)]
            if not explicit:
                if sh._would_shed(None):
                    sh.metrics.backpressure_rejections += 1
                    res.rejected += 1
                    continue
                ev = dataclasses.replace(ev, seqno=self._next_seqno)
                self._next_seqno += 1
            res.merge(sh.submit(
                [dataclasses.replace(
                    ev, user=int(self.spec.local_row(ev.user)))],
                on_invalid=on_invalid, on_overflow="shed"))
        if res.rejected and on_overflow == "raise":
            raise Backpressure(res.admitted, res.rejected,
                               res.first_rejected_seqno, self.n_pending)
        return res

    def add_basket(self, user: int, items: Sequence[int]) -> None:
        """Enqueue one basket addition (Eq. 7–9) for global ``user``."""
        self.submit([Event(KIND_ADD_BASKET, user,
                           items=np.asarray(items, np.int32))])

    def delete_basket(self, user: int, pos: int) -> None:
        """Enqueue the deletion of basket ``pos`` (Eq. 10–12)."""
        self.submit([Event(KIND_DEL_BASKET, user, pos=pos)])

    def delete_item(self, user: int, pos: int, item: int) -> None:
        """Enqueue the deletion of ``item`` from basket ``pos`` (Eq. 13)."""
        self.submit([Event(KIND_DEL_ITEM, user, pos=pos, item=item)])

    # -- unlearning front door ----------------------------------------------

    def forget_user(self, user: int) -> ForgetReceipt:
        """Erase global ``user``'s history and every live trace of it.

        Same contract as :meth:`StreamingEngine.forget_user`, with the
        deletion events submitted THROUGH THE ROUTER: the router owns the
        global seqno counter, and a shard-local submit would assign
        seqnos that collide with later router-assigned ones -- silently
        deduping later legitimate traffic.  Scrubs at the owner shard
        and purges both the router's dead letters (global ids) and the
        shard's (local rows).  An out-of-range user raises
        :class:`InvalidEventError`.
        """
        if not 0 <= user < self.spec.n_users:
            raise InvalidEventError(
                Event(KIND_DEL_BASKET, user),
                f"user {user} outside the deployment's "
                f"[0, {self.spec.n_users}) global range")
        t0 = time.perf_counter()
        self.run_until_drained()
        sh = self.shards[self.spec.shard_of(user)]
        local = int(self.spec.local_row(user))
        nb = int(sh.store.state.n_baskets[local])
        seqnos = _delete_baskets(self, user, nb)
        sh._scrub_user(local)
        purged = (sh._purge_dead_letters(local)
                  + _purge_user(self.dead_letter, user))
        return ForgetReceipt(
            user=user, n_baskets_deleted=nb, seqnos=seqnos,
            purged_dead_letters=purged,
            latency_s=time.perf_counter() - t0,
            residue=sh.store.row_residue([local]))

    # -- micro-batch processing ---------------------------------------------

    def step(self) -> int:
        """Process one micro-batch per shard; returns events applied.

        Three passes: every shard cuts its batch and dispatches its
        summary's copy (``_prepare_step``), then every shard waits for
        its own copy and applies (``_complete_step``), then the logs
        advance (``_finish_step``), so no shard's wait holds back
        another shard's dispatch.  Each shard's ``last_batch_seconds``
        counts only its own phases.
        """
        prepped = []
        for sh in self.shards:
            t0 = time.perf_counter()
            prep = sh._prepare_step()
            prepped.append((sh, prep, time.perf_counter() - t0))
        begun = []
        for sh, prep, dt in prepped:
            t0 = time.perf_counter()
            evs = sh._complete_step(prep)
            begun.append((sh, evs, dt + time.perf_counter() - t0))
        total = 0
        for sh, evs, own_dt in begun:
            if evs:
                # shift the start so elapsed = own phases + own finish
                total += sh._finish_step(evs, time.perf_counter() - own_dt)
        return total

    def run_until_drained(self, max_batches: int = 10_000) -> int:
        """Step all shards until none has pending events."""
        total = 0
        for _ in range(max_batches):
            n = self.step()
            if n == 0:
                break
            total += n
        return total

    # -- serving ------------------------------------------------------------

    def corpora(self) -> List[torch.Tensor]:
        """The shards' cached serving corpora (each shard-local)."""
        return [sh.store.corpus() for sh in self.shards]

    def quantized_corpora(self) -> List[tuple]:
        """The shards' int8 corpora ``[(q, scale), ...]``."""
        return [sh.store.quantized_corpus() for sh in self.shards]

    def recommend(self, user_ids, topn: int = 10, k: Optional[int] = None,
                  alpha: Optional[float] = None,
                  metric: str = "euclidean",
                  quantized: bool = False) -> np.ndarray:
        """Cross-shard top-n recommendations for global ``user_ids``.

        ``core.knn.sharded_recommend_for_users``: per-shard candidate
        top-k, a merge of the [Q, k] lists, then the selected rows
        blended (never a corpus gather).  The request is padded to its
        pow2 bucket as in :meth:`StreamingEngine.recommend`.
        ``quantized=True`` serves the per-shard int8 caches through
        ``sharded_recommend_for_users_quant``, euclidean only; row
        quantization makes its merge bitwise the single-corpus int8
        answer.  Cosine candidates take the plain path (no kernel
        scores cosine).  Returns i32[Q, topn].
        """
        ids, q_n, _ = _pad_request(user_ids)
        if q_n == 0:
            return np.zeros((0, topn), np.int32)
        k = self.params.k_neighbors if k is None else k
        alpha = self.params.alpha if alpha is None else alpha
        if quantized:
            if metric != "euclidean":
                raise ValueError("quantized serving is euclidean-only")
            recs = knn.sharded_recommend_for_users_quant(
                self.quantized_corpora(), ids, k=k, alpha=alpha,
                topn=topn, n_shards=self.spec.n_shards)
        else:
            recs = knn.sharded_recommend_for_users(
                self.corpora(), ids, k=k, alpha=alpha, topn=topn,
                n_shards=self.spec.n_shards, metric=metric)
        return recs.cpu().numpy()[:q_n]

    # -- recovery -----------------------------------------------------------

    def _shard_dir(self, directory: str, shard: int) -> str:
        return os.path.join(directory, f"shard_{shard:03d}")

    def _serialized_legacy(self) -> list:
        return [{"n_shards": e["n_shards"],
                 "logs": [{"watermark": lg["watermark"],
                           "processed_above": sorted(lg["processed_above"])}
                          for lg in e["logs"]]} for e in self._legacy]

    @staticmethod
    def _parse_legacy(raw: list) -> list:
        return [{"n_shards": e["n_shards"],
                 "logs": [{"watermark": lg["watermark"],
                           "processed_above":
                               set(lg.get("processed_above", []))}
                          for lg in e["logs"]]} for e in raw]

    def checkpoint(self, directory: str, step: int) -> None:
        """Commit every shard, then the cross-shard manifest.

        Each shard commits on its own, atomically (its ``LATEST``
        carries its exactly-once log); the ``SHARDS`` manifest (atomic
        too) records the layout, the router's seqno counter and the
        legacy logs.  A crash anywhere leaves shards at possibly
        different steps, which a replay converges.  A directory whose
        manifest is corrupt, or describes another layout, is refused:
        re-partitioned shard files would tear the old manifest's view.
        With a ``checkpointer`` the manifest job is queued after every
        shard's job on the one writer (FIFO).
        """
        os.makedirs(directory, exist_ok=True)
        man_path = os.path.join(directory, _SHARD_MANIFEST)
        if os.path.exists(man_path):
            try:
                man = load_json_checked(man_path)
            except CorruptCheckpointError as e:
                raise CorruptCheckpointError(
                    f"existing manifest {man_path} is torn/corrupt "
                    f"({e}); refusing to commit over a directory whose "
                    "layout cannot be verified -- use a fresh directory "
                    "or restore first") from e
            if man["n_shards"] != self.spec.n_shards \
                    or man["n_users"] != self.spec.n_users:
                raise ValueError(
                    f"checkpoint directory holds a "
                    f"{man['n_shards']}-shard/{man['n_users']}-user "
                    f"layout; refusing to overwrite with "
                    f"{self.spec.n_shards}/{self.spec.n_users} -- use a "
                    "fresh directory after resharding")
        for s, sh in enumerate(self.shards):
            sh.checkpoint(self._shard_dir(directory, s), step)
        payload = {
            "version": 1,
            "n_shards": self.spec.n_shards,
            "n_users": self.spec.n_users,
            "step": step,
            "next_seqno": self._next_seqno,
            "legacy_logs": self._serialized_legacy(),
        }
        if self.checkpointer is not None:
            self.checkpointer.submit(
                functools.partial(atomic_write_json, man_path, payload),
                label=f"{man_path}@{step}")
        else:
            atomic_write_json(man_path, payload)

    def flush_checkpoints(self) -> None:
        """Block until every shard commit and the manifest landed."""
        if self.checkpointer is not None:
            self.checkpointer.flush()

    def restore(self, directory: str) -> None:
        """Install a sharded checkpoint, resharding when layouts differ.

        Same shard count: each shard restores its own commit (after a
        torn crash they may sit at different steps; replay converges
        them).  Another shard count (N→M): :meth:`_restore_resharded`.
        A flat single-engine checkpoint (no manifest, a root ``LATEST``)
        restores as N=1.  Every shard directory is checked for a commit
        before any shard is touched, and the missing ones are named.
        Pending async commits are flushed first.
        """
        self.flush_checkpoints()
        man_path = os.path.join(directory, _SHARD_MANIFEST)
        man = None
        if os.path.exists(man_path):
            try:
                man = load_json_checked(man_path)
            except CorruptCheckpointError as e:
                raise CorruptCheckpointError(
                    f"sharded checkpoint manifest {man_path} is "
                    f"torn/corrupt ({e}); the per-shard commits may "
                    "still be intact -- restore shard directories "
                    "individually or rebuild the manifest") from e
            n_old = man["n_shards"]
            if man["n_users"] != self.spec.n_users:
                raise ValueError(
                    f"checkpoint n_users={man['n_users']} != spec "
                    f"n_users={self.spec.n_users}")
            dirs = [self._shard_dir(directory, s) for s in range(n_old)]
        elif os.path.exists(os.path.join(directory, "LATEST")):
            n_old, dirs = 1, [directory]      # flat single-engine layout
        else:
            raise FileNotFoundError(
                f"no {_SHARD_MANIFEST} manifest or LATEST in {directory}")
        missing = [d for d in dirs
                   if not (os.path.exists(os.path.join(d, "LATEST"))
                           or os.path.exists(os.path.join(d,
                                                          "LATEST.prev")))]
        if missing:
            raise FileNotFoundError(
                f"sharded checkpoint {directory} declares {n_old} "
                f"shard(s) but is missing commit(s) in: "
                f"{', '.join(missing)} — expected shard_000 … "
                f"shard_{n_old - 1:03d}, each holding a LATEST (or "
                "LATEST.prev) commit")
        self._legacy = self._parse_legacy(man.get("legacy_logs", [])
                                          if man else [])
        if n_old == self.spec.n_shards:
            for s, sh in enumerate(self.shards):
                sh.restore(dirs[s])
            self._next_seqno = max(
                [sh._next_seqno for sh in self.shards]
                + ([man["next_seqno"]] if man else []))
        else:
            self._restore_resharded(dirs, n_old)

    def recover_shard(self, shard: int, directory: str) -> dict:
        """Restore ONE shard's commit while its serving stays degraded.

        The shard's serving corpus is frozen first, so cross-shard
        ``recommend`` keeps answering from the pinned snapshot while the
        shard's store restores from its last good commit; the other
        shards are untouched.  On success serving thaws onto the
        recovered state and the recovery info (``{"source",
        "skipped"}``, see ``state_store.load_checkpoint_arrays``) is
        returned; on failure the shard STAYS frozen and the error
        propagates.
        """
        sh = self.shards[shard]
        sh.freeze_serving()
        sh.restore(self._shard_dir(directory, shard))
        info = dict(sh.store.last_restored_meta.get(
            "_recovery", {"source": "LATEST", "skipped": []}))
        sh.thaw_serving()
        return info

    def _restore_resharded(self, dirs: List[str], n_old: int) -> None:
        """N→M restore: re-partition the states, demote the old logs.

        Each old commit is shape-checked without its user count (which
        differs across layouts) and must carry its exactly-once log;
        the global rows are assembled into host buffers through the
        spec bijection, which covers every row, and installed on each
        shard's device.  The shards' own logs start empty.
        """
        spec = self.spec
        leaves, old_logs = [], []
        for d in dirs:
            meta, lv = load_checkpoint_arrays(d)
            probe = dict(meta)
            probe.pop("n_users", None)
            self.shards[0].store._validate_meta(probe)
            log = meta.get("engine")
            if log is None:
                path = os.path.join(d, "ENGINE")
                if os.path.exists(path):       # legacy flat layout
                    with open(path) as f:
                        log = json.load(f)
            if log is None:
                raise ValueError(
                    f"shard checkpoint {d} carries no exactly-once log; "
                    "refusing to reshard (replay could double-apply)")
            leaves.append(lv)
            old_logs.append(log)
        n_total = sum(lv["n_baskets"].shape[0] for lv in leaves)
        if n_total != spec.n_users:
            raise ValueError(f"checkpoint holds {n_total} user rows, spec "
                             f"n_users={spec.n_users}")
        out = []
        for sh in self.shards:
            cfg = sh.store.cfg
            zero = StreamState.zeros(cfg.n_users, cfg.n_items,
                                     cfg.max_baskets, cfg.max_basket_size,
                                     cfg.max_groups, device="cpu")
            out.append({name: getattr(zero, name).numpy()
                        for name in _STATE_LEAVES})
        for so, lv in enumerate(leaves):
            rows = lv["n_baskets"].shape[0]
            u_glob = np.arange(rows, dtype=np.int64) * n_old + so
            keep = u_glob < spec.n_users
            u_glob = u_glob[keep]
            ns, nr = spec.shard_of(u_glob), spec.local_row(u_glob)
            for name in _STATE_LEAVES:
                src = lv[name][keep]
                for s in range(spec.n_shards):
                    m = ns == s
                    out[s][name][nr[m]] = src[m]
        for s, sh in enumerate(self.shards):
            sh.store.install_state(StreamState(
                **{k: torch.from_numpy(v) for k, v in out[s].items()}))
            sh._reset_log()
        self._legacy.append({"n_shards": n_old, "logs": [
            {"watermark": lg["watermark"],
             "processed_above": set(lg.get("processed_above", []))}
            for lg in old_logs]})
        self._next_seqno = max(max(lg["next_seqno"] for lg in old_logs),
                               self._next_seqno)
