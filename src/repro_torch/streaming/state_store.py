"""State store for per-user TIFU-kNN state and its serving corpus cache.

The store owns the ``StreamState`` on one device and the materialized
``[n_users, n_items]`` true-value corpus that kNN queries read, plus
its int8 quantization for the int8 serving path.  A micro-batch touches
a handful of users; the engine marks those rows dirty
(``invalidate_users``) and ``corpus()`` / ``quantized_corpus()`` each
refresh only them (each cache has its own dirty set), or rebuild
whole once more than ``corpus_rebuild_frac`` of the rows are dirty.

Checkpoints use the JAX package's on-disk format, so a commit written by
either package restores into the other bit for bit: the nine leaves in
``state_{step:010d}.npz`` (``np.savez_compressed``), then the atomic
commit point ``LATEST`` (json carrying the step, the store's shape
fields, the npz's CRC32 and size, the co-checkpointed engine log, and a
self-CRC of the metadata), whose predecessor survives as
``LATEST.prev``.  Restore verifies both CRCs and falls back to
``LATEST.prev`` when the newest commit is torn or bit-flipped, so a
corrupt file is detected, never installed.  File I/O retries transient
errors with exponential backoff under a bounded budget; the fault sites
of ``streaming.faults`` sit on the commit and read paths.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import zipfile
import zlib
from typing import (TYPE_CHECKING, Any, Callable, Dict, Optional,
                    Sequence, Set, Tuple)

import numpy as np
import torch

from repro_torch.convert import LEAVES
from repro_torch.core.types import StreamState, resolve_device
from repro_torch.optim.compression import (quantize_int8_rows,
                                           quantize_int8_rows_pitched)
from repro_torch.streaming import faults

if TYPE_CHECKING:  # type-only: the writer runs opaque commit closures
    from repro_torch.streaming.async_checkpoint import AsyncCheckpointer

# the reference's leaf dtypes: f32 vectors and scales, int32 integers
_INT_LEAVES = ("history", "group_sizes", "n_baskets", "n_groups")


class CorruptCheckpointError(RuntimeError):
    """A checkpoint file failed its integrity check (torn or bit-flipped).

    Raised only when NO commit in the directory verifies -- a corrupt
    newest commit with an intact ``LATEST.prev`` falls back silently
    (counted in :attr:`StateStore.restore_fallbacks`).
    """


@dataclasses.dataclass
class StoreConfig:
    """Shapes and cache policy of one state store."""

    n_users: int
    n_items: int
    max_baskets: int
    max_basket_size: int
    max_groups: Optional[int] = None
    # corpus cache: once more than this fraction of user rows is dirty,
    # one full materialize beats a scattered refresh of most rows
    corpus_rebuild_frac: float = 0.25
    # bounded I/O retry budget for checkpoint/restore file operations:
    # transient errors back off base * 2^i and then surface
    io_retries: int = 4
    io_retry_base_s: float = 0.005


def _fsync_dir(path: str) -> None:
    """Make a rename in ``path`` durable.

    The file fsync orders the DATA, the directory fsync orders the
    ENTRY -- both are needed for the crash-anywhere guarantee.
    """
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def with_io_retries(fn: Callable, what: str, retries: int = 4,
                    base_delay_s: float = 0.005,
                    on_retry: Optional[Callable] = None) -> Any:
    """Run ``fn`` retrying transient OSErrors with exponential backoff.

    Bounded budget: ``retries`` re-attempts (delays ``base_delay_s * 2^i``)
    and then the last error propagates -- a dead disk must surface, not
    spin.  ``FileNotFoundError`` is never retried (it is a *state*, not a
    transient), and injected crashes (``faults.InjectedCrash`` is a
    BaseException) pass straight through, exactly like a real SIGKILL.
    ``on_retry`` is called once per re-attempt (metrics hook).
    """
    for attempt in range(retries + 1):
        try:
            return fn()
        except FileNotFoundError:
            raise
        except OSError as e:
            if attempt == retries:
                raise OSError(
                    f"{what}: I/O retry budget exhausted "
                    f"({retries} retries): {e}") from e
            if on_retry is not None:
                on_retry()
            time.sleep(base_delay_s * (2 ** attempt))


def _meta_crc(payload: dict) -> int:
    """Self-CRC of a metadata payload (over canonical json, crc excluded)."""
    probe = {k: v for k, v in payload.items() if k != "meta_crc32"}
    return zlib.crc32(json.dumps(probe, sort_keys=True).encode())


def _file_crc(path: str) -> Tuple[int, int]:
    """``(crc32, n_bytes)`` of a file, read in chunks."""
    crc, n = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc, n
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)


def atomic_write_json(path: str, payload: dict, retries: int = 4,
                      base_delay_s: float = 0.005,
                      on_retry: Optional[Callable] = None) -> None:
    """Write json atomically and durably (the commit-point primitive).

    Tmp-file + fsync + ``os.replace`` + directory fsync, so a crash --
    process OR system -- leaves either the previous intact file or
    nothing, never a truncated one.  A self-CRC (``meta_crc32``) is
    stamped into the payload so *silent* corruption of the committed
    file (bit rot, which the rename protocol cannot prevent) is detected
    on read (:func:`load_json_checked`).  Transient I/O errors are
    retried under a bounded budget.
    """
    payload = dict(payload)
    payload["meta_crc32"] = _meta_crc(payload)
    base = os.path.basename(path)

    def write() -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        faults.trip(f"{base}.pre_replace")
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path) or ".")
        faults.trip(f"{base}.post_replace")

    with_io_retries(write, f"write {path}", retries, base_delay_s,
                    on_retry)


def load_json_checked(path: str, retries: int = 4,
                      base_delay_s: float = 0.005,
                      on_retry: Optional[Callable] = None) -> dict:
    """Read a json commit file, verifying its self-CRC when present.

    Raises :class:`CorruptCheckpointError` on undecodable json or a
    CRC mismatch (torn pre-atomic writers, bit flips); propagates
    ``FileNotFoundError`` untouched (absence is layout information, not
    corruption).  Legacy files without ``meta_crc32`` are accepted
    unverified.
    """
    base = os.path.basename(path)

    def read() -> bytes:
        faults.trip(f"{base}.read")
        # bytes, decoded below: a bit flip can produce invalid UTF-8,
        # which is corruption, not an I/O error to retry
        with open(path, "rb") as f:
            return f.read()

    raw = with_io_retries(read, f"read {path}", retries, base_delay_s,
                          on_retry)
    try:
        meta = json.loads(raw.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptCheckpointError(
            f"{path} is not valid json (torn write or bit flip?): "
            f"{e}") from e
    if not isinstance(meta, dict):
        raise CorruptCheckpointError(f"{path}: expected a json object")
    want = meta.get("meta_crc32")
    if want is not None and _meta_crc(meta) != want:
        raise CorruptCheckpointError(
            f"{path} failed its integrity check "
            f"(meta_crc32={want}, computed={_meta_crc(meta)}): "
            "bit-flipped or hand-edited")
    return meta


def _load_commit(directory: str, meta: dict) -> Dict[str, np.ndarray]:
    """Load + verify the state npz a commit's metadata names.

    Raises :class:`CorruptCheckpointError` when the npz misses the CRC
    recorded at commit time or cannot be parsed; legacy commits without
    ``npz_crc32`` skip the CRC check (their zip structure still has to
    parse).  A commit without ``uv_scale``/``lgv_scale`` (written before
    the scaled representation) gets scales of 1.
    """
    step = meta["step"]
    path = os.path.join(directory, f"state_{step:010d}.npz")
    want = meta.get("npz_crc32")
    if want is not None:
        crc, n = with_io_retries(lambda: _file_crc(path), f"crc {path}")
        if crc != want:
            raise CorruptCheckpointError(
                f"{path} failed its CRC check (recorded {want}, computed "
                f"{crc} over {n} bytes): torn or bit-flipped")

    def read() -> Dict[str, np.ndarray]:
        faults.trip("npz.read")
        with np.load(path) as data:
            return {k: np.asarray(data[k]) for k in data.files}

    try:
        leaves = with_io_retries(read, f"read {path}")
    except FileNotFoundError:
        raise
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        raise CorruptCheckpointError(f"{path} unreadable: {e}") from e
    for scale in ("uv_scale", "lgv_scale"):
        if scale not in leaves:
            leaves[scale] = np.ones(leaves["err_mult"].shape,
                                    leaves["err_mult"].dtype)
    return leaves


def load_checkpoint_arrays(
        directory: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Read the newest VERIFIED commit as host arrays: ``(meta, leaves)``.

    Reads the ``LATEST`` metadata (the atomic commit point), verifies
    its self-CRC and the recorded CRC of the state npz it names, and
    falls back to the previous commit (``LATEST.prev``, kept by
    :meth:`StateStore.checkpoint`) when the newest one is corrupt -- the
    state and its exactly-once log always fall back *together*, so a
    replay re-applies exactly what the surviving commit has not seen
    (never a double-apply).  The chosen commit and any corruption
    skipped on the way are recorded under ``meta["_recovery"]``.
    Raises ``FileNotFoundError`` when neither file exists and
    :class:`CorruptCheckpointError` naming every error when none
    verifies.  Cost: one O(state) read, no device work.
    """
    errors = []
    tried = False
    for name in ("LATEST", "LATEST.prev"):
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            continue
        tried = True
        try:
            meta = load_json_checked(path)
            leaves = _load_commit(directory, meta)
        except (CorruptCheckpointError, OSError) as e:
            errors.append(f"{name}: {e}")
            continue
        meta["_recovery"] = {"source": name, "skipped": list(errors)}
        return meta, leaves
    if not tried:
        raise FileNotFoundError(
            f"no LATEST (or LATEST.prev) commit in {directory}")
    raise CorruptCheckpointError(
        f"no commit in {directory} passes its integrity checks: "
        + "; ".join(errors))


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host array owned by the caller: one copy of ``t``.

    On CUDA the blocking ``.cpu()`` is the copy (and, on the default
    stream, waits for every kernel launched before it); on the CPU
    ``.numpy()`` is a view of the live tensor, which the appliers write
    in place, so it is copied.
    """
    t = t.detach()
    if t.device.type == "cpu":
        return t.numpy().copy()
    return t.cpu().numpy()


def _refresh_corpus_rows(corpus: torch.Tensor, user_vecs: torch.Tensor,
                         uv_scale: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
    """``corpus[rows] = uv_scale[rows] * user_vecs[rows]``, IN PLACE.

    O(|rows| · n_items); ``rows`` are distinct.
    """
    corpus[rows] = user_vecs[rows] * uv_scale[rows, None]
    return corpus


def _requantize_rows(corpus_q: torch.Tensor, scales: torch.Tensor,
                     corpus: torch.Tensor, rows: torch.Tensor) -> None:
    """Re-quantize exactly ``rows`` of the int8 corpus, IN PLACE.

    Per-row scaling makes a row's ``(q, scale)`` depend on that row
    alone, so this equals a from-scratch quantization.  O(|rows| · I).
    """
    corpus_q[rows], scales[rows] = quantize_int8_rows(corpus[rows])


def _dirty_rows(dirty: Set[int], device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.fromiter(dirty, np.int64, len(dirty)),
                           device=device)


class StateStore:
    """Owns the StreamState, the serving corpus caches and persistence.

    ``device`` defaults to CUDA; without a card that raises (pass
    ``device="cpu"`` to run on the CPU).
    """

    def __init__(self, cfg: StoreConfig, device: Any = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = StreamState.zeros(
            cfg.n_users, cfg.n_items, cfg.max_baskets, cfg.max_basket_size,
            cfg.max_groups, device=self.device)
        self._corpus: Optional[torch.Tensor] = None
        self._dirty: Set[int] = set()
        self.corpus_full_builds = 0
        self.corpus_rows_refreshed = 0
        self.corpus_threshold_rebuilds = 0
        self._corpus_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._q_dirty: Set[int] = set()
        self.quant_full_builds = 0
        self.quant_rows_refreshed = 0
        self.quant_threshold_rebuilds = 0
        # degraded serving: while frozen, corpus() and quantized_corpus()
        # answer from these snapshots and refresh nothing
        self._frozen_corpus: Optional[torch.Tensor] = None
        self._frozen_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = \
            None
        # robustness counters (observability only)
        self.io_retries = 0
        self.restore_fallbacks = 0
        self.corruption_detected = 0
        self.last_restored_meta: dict = {}

    def _on_io_retry(self) -> None:
        self.io_retries += 1

    def invalidate_users(self, users: Any) -> None:
        """Mark user rows of the serving caches stale.

        The engine calls this after every micro-batch and stability
        refresh with the touched users; O(|users|) set inserts into the
        dirty set of each cache that exists.
        """
        if self._corpus is None and self._corpus_q is None:
            return            # no cache yet: the first call builds it
        rows = [int(x) for x in np.asarray(users).ravel()]
        if self._corpus is not None:
            self._dirty.update(rows)
        if self._corpus_q is not None:
            self._q_dirty.update(rows)

    def invalidate_all(self) -> None:
        """Drop both caches entirely (out-of-band state edits)."""
        self._corpus = None
        self._dirty.clear()
        self._corpus_q = None
        self._q_dirty.clear()

    def freeze_serving(self) -> None:
        """Enter degraded serving: pin the current corpus snapshot.

        While frozen, :meth:`corpus` answers from the pinned snapshot
        and performs NO refreshes or rebuilds -- so ``recommend`` keeps
        working (on admittedly stale values) while this store's state is
        being recovered underneath it.  The pinned tensor is the cache
        itself, which is safe because nothing refreshes it while frozen;
        :meth:`invalidate_users` keeps filling the dirty sets, which the
        first call after :meth:`thaw_serving` reconciles.  If no corpus
        is cached yet, one is materialized first.  Idempotent.
        """
        if self._frozen_corpus is None:
            self._frozen_corpus = self.corpus()

    def thaw_serving(self) -> None:
        """Leave degraded serving: un-pin the snapshots.

        The next :meth:`corpus` / :meth:`quantized_corpus` call serves
        the live state again: it refreshes the rows dirtied while frozen
        (a restore dropped the caches, so they rebuild fresh).
        """
        self._frozen_corpus = None
        self._frozen_quant = None

    @property
    def serving_degraded(self) -> bool:
        """True while :meth:`freeze_serving` is in effect."""
        return self._frozen_corpus is not None

    def corpus(self) -> torch.Tensor:
        """The materialized true-value corpus f32[n_users, n_items].

        The first call (or one after ``invalidate_all``) densifies
        everything; later calls refresh only the rows dirtied since the
        last call, IN PLACE, so the returned tensor changes under the
        caller at the next refreshing call.  While frozen
        (:meth:`freeze_serving`) the pinned snapshot is returned as is.
        """
        if self._frozen_corpus is not None:
            return self._frozen_corpus
        if self._corpus is None:
            self._corpus = self.state.materialized_user_vecs()
            self._dirty.clear()
            self.corpus_full_builds += 1
        elif len(self._dirty) > self.cfg.corpus_rebuild_frac \
                * self.cfg.n_users:
            self._corpus = self.state.materialized_user_vecs()
            self._dirty.clear()
            self.corpus_full_builds += 1
            self.corpus_threshold_rebuilds += 1
        elif self._dirty:
            rows = _dirty_rows(self._dirty, self.device)
            self.corpus_rows_refreshed += rows.numel()
            _refresh_corpus_rows(self._corpus, self.state.user_vecs,
                                 self.state.uv_scale, rows)
            self._dirty.clear()
        return self._corpus

    def quantized_corpus(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The int8 serving corpus: ``(q int8[M, I], scale f32[M])``.

        ``optim.compression.quantize_int8_rows`` of :meth:`corpus`
        (which this refreshes first), with its own dirty set: the first
        call (or one after ``invalidate_all``, or with more than
        ``corpus_rebuild_frac`` of the rows dirty) quantizes everything,
        later calls re-quantize only the rows dirtied since the last
        call, IN PLACE (same lifetime as :meth:`corpus`).  Either way
        the result equals a from-scratch quantization of ``corpus()``
        bit for bit.  ``q`` is a ``[:, :I]`` view of rows at a 16-byte
        pitch (zero pad columns), which the D-tiled kernel reads as
        16-byte vectors without a copy.  While frozen, the quantization
        of the pinned fp32 snapshot (made on first use, same layout).
        """
        if self._frozen_corpus is not None:
            if self._frozen_quant is None:
                self._frozen_quant = quantize_int8_rows_pitched(
                    self._frozen_corpus)
            return self._frozen_quant
        corpus = self.corpus()
        if self._corpus_q is None or len(self._q_dirty) > \
                self.cfg.corpus_rebuild_frac * self.cfg.n_users:
            if self._corpus_q is not None:
                self.quant_threshold_rebuilds += 1
            self._corpus_q = quantize_int8_rows_pitched(corpus)
            self.quant_full_builds += 1
        elif self._q_dirty:
            rows = _dirty_rows(self._q_dirty, self.device)
            self.quant_rows_refreshed += rows.numel()
            _requantize_rows(*self._corpus_q, corpus, rows)
        self._q_dirty.clear()
        return self._corpus_q

    # -- unlearning surface -------------------------------------------------

    def scrub_rows(self, users: Sequence[int]) -> None:
        """Force the serving caches to drop residue for ``users`` now.

        The unlearning path: after the engine zeroes a forgotten user's
        state rows, the fp32/int8 cache rows still hold the
        pre-deletion values until the next natural refresh.  This marks
        the rows dirty and refreshes whichever caches exist, so the
        forgotten values are gone from every live serving buffer when
        the call returns.  A frozen snapshot is NOT touched -- it is the
        fp32 cache tensor itself, so nothing is refreshed while frozen,
        and the forget shows up as residue in :meth:`row_residue` until
        :meth:`thaw_serving` (the honest answer: the pinned snapshot
        still serves the old values).  Cost: one O(|users| · n_items)
        row refresh per existing cache.
        """
        rows = np.asarray(list(users), np.int64)
        if rows.size == 0:
            return
        self.invalidate_users(rows)
        if self._frozen_corpus is not None:
            return
        if self._corpus_q is not None:
            self.quantized_corpus()   # refreshes the fp32 cache first
        elif self._corpus is not None:
            self.corpus()

    def row_residue(self, users: Sequence[int]) -> Dict[str, float]:
        """Residue of ``users``' rows in every live artifact, by name.

        Max-abs (or count) values over the given rows for the state
        leaves, the fp32/int8 serving caches and any frozen snapshot --
        cache/snapshot keys appear only when that artifact exists (the
        int8 count over the ``[:, :I]`` view, not the pitch).  A fully
        forgotten user reports 0.0 everywhere: the machine-checkable
        no-trace predicate behind ``compliance.certify`` and
        ``forget_user`` receipts.  The rows are indexed and reduced on
        the store's device, then copied to the host once.  No cache
        refresh.
        """
        rows = torch.as_tensor(np.asarray(list(users), np.int64),
                               device=self.device)
        st = self.state
        zero = torch.zeros((), dtype=torch.float64, device=self.device)

        def absmax(t: torch.Tensor) -> torch.Tensor:
            r = t[rows]
            return r.abs().max().double() if r.numel() else zero

        parts = {
            "user_vec_absmax": absmax(st.user_vecs),
            "last_group_absmax": absmax(st.last_group_vecs),
            "history_ids": (st.history[rows] >= 0).sum().double(),
            "n_baskets": st.n_baskets[rows].sum().double(),
            "n_groups": st.n_groups[rows].sum().double(),
        }
        if self._corpus is not None:
            parts["corpus_absmax"] = absmax(self._corpus)
        if self._corpus_q is not None:
            parts["quant_nonzero"] = (self._corpus_q[0][rows] != 0) \
                .sum().double()
        if self._frozen_corpus is not None:
            parts["frozen_absmax"] = absmax(self._frozen_corpus)
        host = torch.stack(list(parts.values())).cpu().numpy()
        return {name: float(v) for name, v in zip(parts, host)}

    # -- persistence (exactly-once recovery substrate) ----------------------

    def _snapshot_leaves(self) -> Dict[str, np.ndarray]:
        """Copy every state leaf to host memory, owned by the caller.

        One device-to-host copy a leaf on CUDA, one host copy on the CPU
        (:func:`_host_copy`): the appliers update the live tensors in
        place, so a view would show later micro-batches.  This is the
        "snapshot" half of snapshot-then-write and the only O(state)
        cost that stays on the caller's thread.
        """
        return {n: _host_copy(getattr(self.state, n)) for n in LEAVES}

    def checkpoint(self, directory: str, step: int,
                   extra_meta: Optional[dict] = None) -> str:
        """Write one atomic checkpoint commit; returns the npz path.

        Synchronous snapshot-then-write: :meth:`_snapshot_leaves` now,
        :meth:`_write_commit` inline.  The state npz is made durable
        FIRST; the ``LATEST`` metadata write (which carries
        ``extra_meta``, e.g. the engine's exactly-once log, plus the
        npz's CRC32) is the single atomic commit point.  The previous
        ``LATEST`` survives as ``LATEST.prev``.  Transient I/O errors
        retry under the config's bounded budget.  Cost: one O(state)
        device-to-host copy + compressed write.
        """
        return self._write_commit(directory, step, self._snapshot_leaves(),
                                  extra_meta)

    def checkpoint_async(self, checkpointer: "AsyncCheckpointer",
                         directory: str, step: int,
                         extra_meta: Optional[dict] = None) -> str:
        """Snapshot now, commit on the background writer; returns npz path.

        The caller-thread cost is one :meth:`_snapshot_leaves` copy; the
        serialize/fsync/atomic-replace sequence (identical bytes and
        identical fault sites to :meth:`checkpoint`) runs as a FIFO job
        on ``checkpointer``'s worker thread.  Until its ``LATEST``
        replace lands, restore sees the previous commit, never a torn
        one.  A writer-thread failure (including an injected crash)
        surfaces at the checkpointer's next ``submit``/``flush`` --
        callers must flush before trusting the returned path exists.
        """
        leaves = self._snapshot_leaves()
        path = os.path.join(directory, f"state_{step:010d}.npz")
        checkpointer.submit(
            lambda: self._write_commit(directory, step, leaves, extra_meta),
            label=f"{directory}@{step}")
        return path

    def _write_commit(self, directory: str, step: int,
                      leaves: Dict[str, np.ndarray],
                      extra_meta: Optional[dict] = None) -> str:
        """Serialize ``leaves`` and land the atomic ``LATEST`` commit.

        The write half of snapshot-then-write.  ``leaves`` must be
        host-owned copies (:meth:`_snapshot_leaves`): this never touches
        ``self.state``, so the engine may keep applying batches while
        it writes.
        """
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"state_{step:010d}.npz")
        tmp = path + ".tmp"

        def write_npz() -> Tuple[int, int]:
            faults.trip("npz.pre_write")
            with open(tmp, "wb") as f:
                np.savez_compressed(f, **leaves)
                f.flush()
                os.fsync(f.fileno())
            # CRC over the durable tmp bytes: recorded in LATEST, checked
            # on every restore
            crc, n = _file_crc(tmp)
            faults.trip("npz.pre_replace")
            os.replace(tmp, path)
            _fsync_dir(directory)
            faults.trip("npz.post_replace")
            return crc, n

        crc, n_bytes = with_io_retries(
            write_npz, f"write {path}", self.cfg.io_retries,
            self.cfg.io_retry_base_s, self._on_io_retry)
        self._retain_previous_commit(directory)
        meta = dict(step=step, **dataclasses.asdict(self.cfg))
        meta["npz_crc32"] = crc
        meta["npz_bytes"] = n_bytes
        if extra_meta:
            meta.update(extra_meta)
        # LATEST is the single commit point: the npz above is durable
        # before this replace lands, and the engine's exactly-once log
        # rides in the SAME atomic write
        atomic_write_json(os.path.join(directory, "LATEST"), meta,
                          self.cfg.io_retries, self.cfg.io_retry_base_s,
                          self._on_io_retry)
        return path

    def _retain_previous_commit(self, directory: str) -> None:
        """Copy the current ``LATEST`` to ``LATEST.prev`` (atomically).

        Byte-for-byte, so the copied file's self-CRC stays valid; a
        crash between the copy and the new ``LATEST`` replace leaves
        ``LATEST == LATEST.prev`` -- consistent.  The fallback depth is
        one: state and exactly-once log always travel together, and a
        two-commits-old state converges by replay.
        """
        cur = os.path.join(directory, "LATEST")
        if not os.path.exists(cur):
            return

        def copy() -> None:
            with open(cur, "rb") as f:
                raw = f.read()
            tmp = cur + ".prev.tmp"
            with open(tmp, "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, cur + ".prev")
            _fsync_dir(directory)

        with_io_retries(copy, f"retain {cur}.prev", self.cfg.io_retries,
                        self.cfg.io_retry_base_s, self._on_io_retry)

    def _validate_meta(self, meta: dict) -> None:
        """Reject checkpoints written under different shape dimensions.

        Installing wrong-shaped state either fails far from the cause or
        runs with aliased user/item indices.
        """
        mismatches = []
        for field in ("n_users", "n_items", "max_baskets",
                      "max_basket_size"):
            want = getattr(self.cfg, field)
            got = meta.get(field)
            if got is not None and got != want:
                mismatches.append(f"{field}: checkpoint={got} store={want}")
        k_ckpt = meta.get("max_groups") or meta.get("max_baskets")
        k_cfg = self.cfg.max_groups or self.cfg.max_baskets
        if meta.get("max_baskets") is not None and k_ckpt != k_cfg:
            mismatches.append(
                f"max_groups (effective): checkpoint={k_ckpt} store={k_cfg}")
        if mismatches:
            raise ValueError(
                "checkpoint/store shape mismatch -- refusing to restore: "
                + "; ".join(mismatches))

    def install_state(self, state: StreamState) -> None:
        """Replace the owned state out-of-band.

        Moves the leaves onto the store's device and drops the serving
        caches (every row may have changed); a frozen snapshot keeps
        serving until :meth:`thaw_serving`.  Callers are responsible for
        shape-validating ``state`` against the config.
        """
        self.state = StreamState(**{n: getattr(state, n).to(self.device)
                                    for n in LEAVES})
        self.invalidate_all()

    def restore(self, directory: str) -> int:
        """Install the checkpoint in ``directory``; returns its step.

        Reads the newest verified commit (:func:`load_checkpoint_arrays`,
        falling back to ``LATEST.prev``), validates its shape metadata
        against this store's config (refusing mismatches loudly), keeps
        the parsed metadata in :attr:`last_restored_meta` (the engine's
        exactly-once log rides in ``meta["engine"]``) and installs the
        leaves on the store's device with the reference's dtypes (f32
        vectors and scales, int32 integer leaves).  Cost: one O(state)
        read + host-to-device copy.
        """
        meta, leaves = load_checkpoint_arrays(directory)
        self._validate_meta(meta)
        rec = meta.get("_recovery", {})
        if rec.get("source") not in (None, "LATEST"):
            self.restore_fallbacks += 1
        self.corruption_detected += len(rec.get("skipped", ()))
        self.last_restored_meta = meta
        self.install_state(StreamState(**{
            n: torch.from_numpy(np.asarray(
                leaves[n], np.int32 if n in _INT_LEAVES else np.float32))
            for n in LEAVES}))
        return meta["step"]
