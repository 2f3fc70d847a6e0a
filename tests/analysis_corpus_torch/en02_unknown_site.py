# ruff: noqa
"""Corpus case: trip() on an unregistered fault-site name (EN02).

The site name is misspelled ("pre_wriet"), so the fault injector never
fires there and the chaos tests silently stop covering that crash
window.
"""
from repro_torch.streaming import faults


def commit(path, payload):
    faults.trip("npz.pre_wriet")
    with open(path, "w") as f:
        f.write(payload)
