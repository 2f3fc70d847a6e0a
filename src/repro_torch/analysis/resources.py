"""What ptxas compiled, held against the contracts (KC01, KC03).

The counterpart of the JAX package's ``tests/test_vmem_model.py``, which
ties the VMEM models to real allocations: here the verbose build's log
(``build.library(verbose=True)`` keeps ``nvcc -Xptxas -v``'s output in
``build.last_build_log``) gives one record per compiled instance of a
kernel, and :func:`check_compiled` holds those to each contract's
instance count, shared memory and spills.  Only a build on a machine
with ``nvcc`` has such a log; nothing here makes one up.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List

from repro_torch.analysis.contracts import KernelContract
from repro_torch.analysis.report import Finding

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


@dataclasses.dataclass
class Instance:
    """One compiled instance of a kernel, as ptxas reports it."""

    kernel: str          # the source name
    mangled: str
    registers: int = 0
    smem: int = 0        # static shared memory, bytes
    spill_stores: int = 0
    spill_loads: int = 0
    stack: int = 0

    @property
    def spill(self) -> int:
        """The bytes spilled: ptxas's spill stores (the loads count each
        read of them again)."""
        return self.spill_stores


def kernel_name(mangled: str) -> str:
    """The source name of an Itanium-mangled kernel name: the last
    component of its (possibly nested, possibly internal) name before
    its template arguments.  ``_ZN12_GLOBAL__N_19my_kernelIiEEvPf`` ->
    ``my_kernel``; an unmangled name is returned as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    s, i = mangled[2:], 0
    nested = s.startswith("N")
    i += nested
    last = None
    while i < len(s):
        if s[i] == "L":
            i += 1
            continue
        m = re.match(r"\d+", s[i:])
        if not m:
            break
        n = int(m.group())
        i += len(m.group())
        last = s[i:i + n]
        i += n
        if not nested:
            break
    return last or mangled


def parse_ptxas(log: str) -> List[Instance]:
    """One :class:`Instance` per ``Compiling entry function`` of a
    ``-Xptxas -v`` log, with the registers, static shared memory, stack
    and spills that ptxas reports for it."""
    out: List[Instance] = []
    cur = None
    props_of = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = Instance(kernel_name(m.group(1)), m.group(1))
            out.append(cur)
            props_of = None
            continue
        m = _PROPS.search(line)
        if m:
            props_of = m.group(1)
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m and props_of in (None, cur.mangled):
            cur.stack, cur.spill_stores, cur.spill_loads = \
                (int(x) for x in m.groups())
            continue
        m = _USED.search(line)
        if m:
            cur.registers = int(m.group(1))
            s = _SMEM.search(line)
            cur.smem = int(s.group(1)) if s else 0
    return out


def _f(rule: str, path: str, msg: str) -> Finding:
    return Finding(rule=rule, path=path, line=1, message=msg)


def check_compiled(registry, records: Iterable[Instance],
                   smem_optin: int) -> List[Finding]:
    """The compiled library against the contracts.

    KC01 where a kernel's instance count differs from the sum that the
    contracts naming it declare (a header's kernel is compiled once in
    each source that launches it), or where a compiled kernel is named
    by no contract.  KC03 where an instance's static shared memory
    passes the contract's ``static_smem``, where static plus the
    modelled dynamic bytes pass ``smem_optin``, or where a spill passes
    ``spill_bytes``.
    """
    contracts: List[KernelContract] = list(
        registry.values() if isinstance(registry, dict) else registry)
    want: Dict[str, int] = {}
    owners: Dict[str, List[KernelContract]] = {}
    for c in contracts:
        for k in c.kernels:
            want[k] = want.get(k, 0) + int(c.instantiations.get(k, 0))
            owners.setdefault(k, []).append(c)
    records = list(records)
    got: Dict[str, int] = {}
    for r in records:
        got[r.kernel] = got.get(r.kernel, 0) + 1
    out: List[Finding] = []
    for k in sorted(set(want) | set(got)):
        if k not in owners:
            out.append(_f("KC01", "build.last_build_log",
                          f"ptxas compiled `{k}` ({got[k]} instances), "
                          "which no contract names"))
        elif got.get(k, 0) != want[k]:
            out.append(_f("KC01", owners[k][0].source,
                          f"`{k}`: {got.get(k, 0)} compiled instances, "
                          f"the contracts declare {want[k]}"))
    for r in records:
        for c in owners.get(r.kernel, []):
            static = int(c.static_smem.get(r.kernel, 0))
            if r.smem > static:
                out.append(_f("KC03", c.source,
                              f"{c.entry}: `{r.kernel}` ({r.mangled}) has "
                              f"{r.smem} static bytes, the contract "
                              f"declares {static}"))
            try:
                dyn = c.max_smem_bytes().get(r.kernel, 0)
            except (TypeError, ValueError, KeyError):
                dyn = 0     # the source rules report the model
            if r.smem + dyn > smem_optin:
                out.append(_f("KC03", c.source,
                              f"{c.entry}: `{r.kernel}` ({r.mangled}) "
                              f"takes {r.smem} static + {dyn} dynamic "
                              f"bytes > a block's {smem_optin}"))
            allowed = int(c.spill_bytes.get(r.kernel, 0))
            if r.spill > allowed:
                out.append(_f("KC03", c.source,
                              f"{c.entry}: `{r.kernel}` ({r.mangled}) "
                              f"spills {r.spill_stores} bytes stored, "
                              f"{r.spill_loads} loaded; the contract "
                              f"allows {allowed}"))
    return out
