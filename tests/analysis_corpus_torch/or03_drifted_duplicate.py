# ruff: noqa
"""Corpus case: intentional duplicate whose body drifted (OR03).

tiled_thing_ref spells its tile count with floor division instead of
ceil division: the off-by-one-tile drift the normalized body comparison
exists to catch (cdiv(a, b) normalizes to -(-a // b), which is NOT
a // b).
"""


def cdiv(a, b):
    return -(-a // b)


def tiled_thing(x, d, bd=256):
    nt = cdiv(d, bd)
    acc = 0.0
    for t in range(nt):
        acc = acc + x[t]
    return acc


def tiled_thing_ref(x, d, bd=256):
    nt = d // bd
    acc = 0.0
    for t in range(nt):
        acc = acc + x[t]
    return acc
