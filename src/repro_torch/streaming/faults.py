"""Deterministic fault injection for the streaming engine.

Deletions must *take effect*: a delete event silently dropped on a
crash, double-applied on redelivery, or resurrected from a torn
checkpoint is a compliance violation.  The exactly-once log and the
atomic ``LATEST`` commit of ``state_store`` guard against that; this
module is the harness that exercises those guarantees under failure,
deterministically and under seed control.  It is backend-free (numpy
only) and keeps the site names of the JAX package's ``faults`` letter
for letter, so one fault schedule drives either package.

Mechanism: the store's commit/fsync/read sites call :func:`trip` with a
stable site name (the canonical list is :data:`CRASH_SITES` /
:data:`SHARD_CRASH_SITES` / :data:`READ_SITES`).  With no plan
installed, ``trip`` is a no-op costing one attribute read -- production
code paths carry no fault logic.  Inside ``with inject(plan):`` the
active :class:`FaultPlan` decides, per trip, whether to raise

  * :class:`InjectedCrash` -- simulates the process dying at that exact
    point.  Derives from ``BaseException`` (like ``KeyboardInterrupt``)
    so no ``except Exception``/``except OSError`` retry or cleanup
    handler can accidentally "survive" a crash; and

  * :class:`InjectedIOError` -- a transient I/O failure (``OSError``
    subclass), which the store's bounded retry-with-backoff loop is
    expected to absorb.

File corruption (torn writes from dying disks, bit rot) cannot be
modeled as an exception at a site -- it is injected *between* runs by
:func:`tear_file` / :func:`bitflip_file` on a committed file class, and
the recovery path must detect it via the checksums recorded in the
commit metadata (``state_store``) and fall back to the last good commit.

Event-stream faults (at-least-once redelivery, reordering, duplication)
are produced by :func:`redelivered`, seeded.

Typical schedule::

    plan = FaultPlan(crash_site="LATEST.pre_replace")
    with inject(plan):
        try:
            engine.checkpoint(ckpt_dir, step)
        except InjectedCrash:
            pass                       # the "process" died here
    engine = rebuild()                 # fresh process
    engine.restore(ckpt_dir)           # must find a consistent commit
    engine.submit(events)              # at-least-once replay ...
    engine.submit(redelivered(events, seed=7))   # ... with duplicates
    engine.run_until_drained()         # state must match fault-free run
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "CRASH_SITES", "SHARD_CRASH_SITES", "READ_SITES", "ASYNC_CRASH_SITES",
    "InjectedCrash", "InjectedIOError", "FaultPlan",
    "inject", "active_plan", "trip",
    "tear_file", "bitflip_file", "redelivered",
]


# Commit-path sites of one engine checkpoint, in temporal order.  A crash
# at each must leave a restorable directory.
CRASH_SITES = (
    "npz.pre_write",        # before the state npz tmp file is written
    "npz.pre_replace",      # npz durable in tmp, not yet renamed
    "npz.post_replace",     # npz committed, LATEST still old
    "LATEST.pre_replace",   # new LATEST durable in tmp, not yet renamed
    "LATEST.post_replace",  # commit complete
)

# Additional sites of a sharded checkpoint (the SHARDS manifest commit).
SHARD_CRASH_SITES = CRASH_SITES + (
    "SHARDS.pre_replace",
    "SHARDS.post_replace",
)

# Restore-path read sites (targets for transient I/O errors).
READ_SITES = ("LATEST.read", "npz.read")

# Background-writer sites of an async (snapshot-then-write) checkpoint:
# the worker thread trips "async.dequeue" just before it starts a
# dequeued commit job and "async.post_commit" right after the job's
# atomic LATEST replace.  A crash at either point dies on the *writer*
# thread — the engine keeps streaming and must observe the failure at
# the next flush/commit boundary.
ASYNC_CRASH_SITES = (
    "async.dequeue",
    "async.post_commit",
)


class InjectedCrash(BaseException):
    """A simulated process death at a named fault site.

    BaseException on purpose: retry loops and cleanup handlers that
    catch ``Exception``/``OSError`` must not be able to swallow a crash
    — a real SIGKILL would not be catchable either.
    """

    def __init__(self, site: str):
        super().__init__(f"injected crash at fault site {site!r}")
        self.site = site


class InjectedIOError(OSError):
    """A transient I/O failure at a named fault site (retryable)."""

    def __init__(self, site: str):
        super().__init__(f"injected transient I/O error at {site!r}")
        self.site = site


@dataclasses.dataclass
class FaultPlan:
    """One deterministic fault schedule.

    ``crash_site``: site name to crash at (None = never crash);
    ``crash_on_hit``: crash on the Nth trip of that site (1-based) — a
    multi-shard checkpoint trips each site once per shard, so this
    selects *which* shard's commit dies;
    ``io_errors``: site -> number of transient ``InjectedIOError`` to
    raise at that site before letting it succeed (exercises the bounded
    retry budget; counts are consumed in place).

    ``fired`` records every site tripped, in order — assertions can pin
    that a schedule actually reached its target site.
    """

    crash_site: Optional[str] = None
    crash_on_hit: int = 1
    io_errors: Dict[str, int] = dataclasses.field(default_factory=dict)
    fired: List[str] = dataclasses.field(default_factory=list)
    _crash_hits: int = dataclasses.field(default=0, repr=False)

    def on_trip(self, site: str) -> None:
        self.fired.append(site)
        if self.io_errors.get(site, 0) > 0:
            self.io_errors[site] -= 1
            raise InjectedIOError(site)
        if site == self.crash_site:
            self._crash_hits += 1
            if self._crash_hits >= self.crash_on_hit:
                raise InjectedCrash(site)


_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, or None (no fault injection)."""
    return _ACTIVE


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Install ``plan`` for the duration of the block (not reentrant)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("fault plans do not nest")
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None


def trip(site: str) -> None:
    """Fault site hook: no-op unless a plan is installed via inject()."""
    if _ACTIVE is not None:
        _ACTIVE.on_trip(site)


# ---------------------------------------------------------------------------
# File corruption (injected between runs, detected by commit checksums)
# ---------------------------------------------------------------------------

def tear_file(path: str, keep_frac: float = 0.5) -> int:
    """Truncate ``path`` to a prefix — a torn write.  Returns new size.

    ``keep_frac=0`` models a created-but-empty file.  The checksums in
    the commit metadata must catch the tear on restore.
    """
    size = os.path.getsize(path)
    keep = int(size * keep_frac)
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def bitflip_file(path: str, seed: int = 0, n_bits: int = 1) -> list:
    """Flip ``n_bits`` seeded-random bits in ``path``; returns offsets.

    Models silent media corruption: the file stays the same size and
    (for json) may even stay parseable — only a checksum catches it.
    """
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if not data:
        return []
    rng = np.random.default_rng(seed)
    offsets = []
    for _ in range(n_bits):
        off = int(rng.integers(0, len(data)))
        data[off] ^= 1 << int(rng.integers(0, 8))
        offsets.append(off)
    with open(path, "wb") as f:
        f.write(bytes(data))
    return offsets


# ---------------------------------------------------------------------------
# Event-stream faults (at-least-once source behaviors)
# ---------------------------------------------------------------------------

def redelivered(events, seed: int = 0, dup_frac: float = 0.5,
                shuffle: bool = True) -> list:
    """A seeded at-least-once redelivery of ``events``.

    Samples ``dup_frac`` of the events (each keeps its original seqno —
    redeliveries carry the seqno of their first delivery) and optionally
    shuffles them: duplicates may arrive in any order, only FIRST
    deliveries are contractually in-order.
    """
    rng = np.random.default_rng(seed)
    events = list(events)
    mask = rng.random(len(events)) < dup_frac
    dups = [ev for ev, m in zip(events, mask) if m]
    if shuffle:
        rng.shuffle(dups)
    return dups
