# ruff: noqa
"""Corpus case: a background thread writes durable bytes off the commit
path (EN01, thread-target sub-check).

Every function here is private, so the public-path half of EN01 sees
nothing; but ``_start`` hands ``_flush_loop`` to a thread, and the
thread keeps writing raw bytes long after any caller's commit
discipline could apply.  The spawned target must reach
``atomic_write_json`` itself.
"""
import threading


class _Flusher:
    def _start(self):
        self._t = threading.Thread(target=self._flush_loop, daemon=True)
        self._t.start()

    def _flush_loop(self):
        while self._live:
            with open(self._path, "wb") as f:
                f.write(self._drain().cpu().numpy().tobytes())
