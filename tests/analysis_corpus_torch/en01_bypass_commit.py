# ruff: noqa
"""Corpus case: durable write bypassing the atomic commit (EN01).

save_snapshot writes the tensors' bytes directly at the destination
path: a crash mid-write leaves a torn file with no LATEST manifest to
fall back to.  Every public durable-write path must reach
atomic_write_json.
"""
import os

import numpy as np


def atomic_write_json(path, payload):
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)


def save_snapshot(path, arrays):
    np.savez(path, **{k: v.cpu().numpy() for k, v in arrays.items()})
