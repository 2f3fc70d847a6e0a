"""Rule family (a): kernel contracts vs the CUDA sources (KC01–KC08).

The JAX package checks each ``pallas_call`` site against its contract;
here each C entry of ``kernels/csrc/`` is checked against its contract,
in the text alone (``cuda_src``), together with ``build.py``'s lists
(read with ``ast``):

* KC01 every ``__global__`` is named by a contract, every contract's
  entry, source and kernels exist and match what the entry launches,
  every ``SIGNATURES`` key has a contract, every source is built;
* KC02 each ``extern "C"`` prototype maps onto its ctypes argtypes;
* KC03 dynamic + static shared memory at the max shapes fits a block's
  opt-in, every ``constexpr SMEM_MAX`` equals it, and a kernel whose
  dynamic shared memory passes 48 KiB has its limit raised;
* KC04 ceil-division and persistent grids have their tail guards;
* KC05 tensor-core instructions accumulate in f32/s32 as declared;
* KC06 no ``double``; KC07 no approximate math where parity is exact,
  and no fast-math flag; KC08 running accumulators in float/int.

Every check is a function of parsed text and contracts, so the corpus
(``tests/analysis_corpus_torch/``) drives single snippets through the
same code the repo-level linter runs.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, \
    Tuple

from repro_torch.analysis import cuda_src
from repro_torch.analysis.contracts import ACCUMULATOR_TYPES, \
    INEXACT_SOURCES, KernelContract
from repro_torch.analysis.cuda_src import CudaSource, squash
from repro_torch.analysis.report import Finding

# Dynamic shared memory a kernel may take without raising its limit.
DEFAULT_DYNAMIC_SMEM = 48 * 1024

# Accumulate types a tensor-core instruction may use (KC05): int8
# operands accumulate exactly in s32, everything else in f32.
MMA_ACCUM_TYPES = ("f32", "s32")

# ctypes argtype of each C parameter type (KC02); a pointer is c_void_p.
CTYPES = {"int": "c_int", "int32_t": "c_int", "bool": "c_int",
          "long long": "c_longlong", "int64_t": "c_longlong",
          "float": "c_float"}

# Approximate intrinsics, banned where parity is exact (KC07).
APPROX_INTRINSICS = frozenset({
    "__expf", "__logf", "__log2f", "__powf", "__sinf", "__cosf", "__tanf",
    "__fdividef", "rsqrtf", "expf", "exp2f", "logf", "tanhf", "erff",
})
_APPROX_CALL = re.compile(
    r"\b(" + "|".join(sorted(APPROX_INTRINSICS)) + r")\s*\(")
_APPROX_PTX = re.compile(r"\.approx\b")

# nvcc flags that trade exactness for speed (KC07).
FAST_MATH_FLAGS = ("--use_fast_math", "-use_fast_math", "-ftz=true",
                   "-prec-div=false", "-prec-sqrt=false")

_CONTROL = frozenset({"return", "if", "for", "while", "else", "case",
                      "goto", "using", "typedef", "delete", "new",
                      "throw", "template", "typename", "switch", "do",
                      "break", "continue", "asm", "static_assert"})
_QUALIFIERS = r"(?:(?:const|constexpr|static|volatile|register)\s+)*"


@dataclasses.dataclass
class BuildInfo:
    """What ``kernels/build.py`` declares, read without importing it."""

    path: Path
    sources: Tuple[str, ...]
    headers: Tuple[str, ...]
    nvcc_flags: Tuple[str, ...]
    signatures: Dict[str, List[str]]
    lines: Dict[str, int]


def read_build(path: Path) -> BuildInfo:
    """``SOURCES``, ``HEADERS``, ``NVCC_FLAGS`` and ``SIGNATURES`` (as
    ctypes names: ``c_void_p``, ``c_int``, ...) of a ``build.py``."""
    path = Path(path)
    tree = ast.parse(path.read_text())
    env: Dict[str, ast.expr] = {}
    for node in tree.body:
        target, value = None, None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        if isinstance(target, ast.Name):
            env[target.id] = value

    def strings(name: str) -> Tuple[str, ...]:
        val = env.get(name)
        if isinstance(val, (ast.Tuple, ast.List)):
            return tuple(e.value for e in val.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str))
        return ()

    def ctype(e: ast.expr) -> str:
        seen = 0
        while isinstance(e, ast.Name) and e.id in env and seen < 4:
            e, seen = env[e.id], seen + 1
        if isinstance(e, ast.Attribute):
            return e.attr
        if isinstance(e, ast.Name):
            return e.id
        return ast.dump(e)

    sigs: Dict[str, List[str]] = {}
    lines: Dict[str, int] = {}
    val = env.get("SIGNATURES")
    if isinstance(val, ast.Dict):
        for k, v in zip(val.keys, val.values):
            if isinstance(k, ast.Constant) and isinstance(v, (ast.List,
                                                              ast.Tuple)):
                sigs[k.value] = [ctype(e) for e in v.elts]
                lines[k.value] = k.lineno
    return BuildInfo(path, strings("SOURCES"), strings("HEADERS"),
                     strings("NVCC_FLAGS"), sigs, lines)


def _f(rule: str, path, line: int, msg: str) -> Finding:
    return Finding(rule=rule, path=str(path), line=line, message=msg)


def visible_kernels(src: CudaSource,
                    sources: Mapping[str, CudaSource]) -> Dict[str, Tuple[
                        CudaSource, cuda_src.Function]]:
    """name -> (file, definition) of every ``__global__`` the source and
    the headers it includes define."""
    out = {}
    for s in cuda_src.include_closure(src, dict(sources)):
        for g in s.globals():
            out.setdefault(g.name, (s, g))
    return out


def kernel_text(src: CudaSource, fn: cuda_src.Function) -> str:
    """The bare text of a kernel's body and of the functions of its file
    that it calls, transitively: what runs as the kernel."""
    parts = []
    for name in sorted(src.reachable(fn.name)):
        for f in src.functions.get(name, []):
            if name == fn.name and f is not fn:
                continue
            parts.append(src.body(f))
    return "\n".join(parts)


def grid_kind(expanded: str) -> str:
    """'cdiv' for a ceil-division grid, 'persistent' for one capped by
    ``min`` or a conditional, else 'exact'."""
    s = squash(expanded)
    if re.search(r"\bmin\(", s) or "?" in s:
        return "persistent"      # (of work items, ceil-divided or not)
    for a, b in re.findall(r"\+([\w<>:]+)-1\)\)?/\(?([\w<>:]+)", s):
        if a == b:
            return "cdiv"
    for a, b in re.findall(r"\+(\d+)\)\)?/\(?(\d+)", s):
        if int(a) + 1 == int(b):
            return "cdiv"
    return "exact"


def declared_types(text: str) -> Dict[str, Set[str]]:
    """name -> the C types it is declared with in ``text`` (simple
    declarations: ``float a[4], b = 0.f;``)."""
    out: Dict[str, Set[str]] = {}
    while True:      # brace initialisers: "= {0.f, 0.f}" -> "= 0"
        cut = re.sub(r"=\s*\{[^{}]*\}", "= 0", text)
        if cut == text:
            break
        text = cut
    for stmt in re.split(r"[;{}]", text):
        m = re.match(_QUALIFIERS + r"((?:unsigned\s+|signed\s+)?"
                     r"(?:long\s+long|[A-Za-z_]\w*))\s+(.+)$",
                     stmt.strip(), re.S)
        if not m or m.group(1) in _CONTROL:
            continue
        for decl in cuda_src.split_top(m.group(2)):
            d = re.match(r"[*&\s]*([A-Za-z_]\w*)\s*(?:\[|=|$)", decl)
            if d:
                out.setdefault(d.group(1), set()).add(
                    " ".join(m.group(1).split()))
    return out


def _check_registry(sources: Mapping[str, CudaSource], build: BuildInfo,
                    contracts: Sequence[KernelContract]) -> List[Finding]:
    """KC01 across the registry: every ``__global__`` named, every
    ``SIGNATURES`` key and source accounted for."""
    out: List[Finding] = []
    named: Dict[str, Set[str]] = {}
    for c in contracts:
        if c.source in sources:
            for s in cuda_src.include_closure(sources[c.source],
                                              dict(sources)):
                for k in c.kernels:
                    named.setdefault(s.path.name, set()).add(k)
    for name, s in sorted(sources.items()):
        for g in s.globals():
            if g.name not in named.get(name, set()):
                out.append(_f("KC01", s.path, g.line,
                              f"__global__ `{g.name}` is named by no "
                              "KernelContract"))
        if name.endswith(".cuh") and name not in build.headers:
            out.append(_f("KC01", build.path, 1,
                          f"header {name} is not in build.HEADERS (an "
                          "edit would not rebuild)"))
        elif name.endswith(".cu") and name not in build.sources:
            out.append(_f("KC01", build.path, 1,
                          f"source {name} is not in build.SOURCES (never "
                          "compiled)"))
    entries = {c.entry for c in contracts}
    for entry in sorted(set(build.signatures) - entries):
        out.append(_f("KC01", build.path, build.lines.get(entry, 1),
                      f"SIGNATURES entry `{entry}` has no KernelContract"))
    for c in contracts:
        if c.entry not in build.signatures:
            out.append(_f("KC01", build.path, 1,
                          f"contract for `{c.entry}` ({c.module}) has no "
                          "SIGNATURES entry"))
    return out


def _check_launched(c: KernelContract, src: CudaSource,
                    kernels: Mapping[str, object]) -> Tuple[
                        List[Finding], List[cuda_src.Launch]]:
    """KC01 for one contract: its entry and kernels exist, and the
    kernels the entry launches are those it names."""
    out: List[Finding] = []
    protos = {p.name: p for p in src.prototypes()}
    if c.entry not in protos:
        out.append(_f("KC01", src.path, 1,
                      f"contract for `{c.entry}`: no extern \"C\" entry "
                      f"of that name in {c.source}"))
        return out, []
    for k in c.kernels:
        if k not in kernels:
            out.append(_f("KC01", src.path, protos[c.entry].line,
                          f"{c.entry}: contract names `{k}`, which "
                          f"{c.source} and its headers do not define"))
    reach = src.reachable(c.entry)
    launches = [x for x in src.launches(set(kernels)) if x.function in reach]
    launched: Set[str] = set()
    for x in launches:
        if not x.kernels:
            out.append(_f("KC01", src.path, x.line,
                          f"{c.entry}: cannot tell which kernel "
                          f"`{x.callee}<<<...>>>` launches"))
        launched |= set(x.kernels)
    for k in sorted(launched - set(c.kernels)):
        out.append(_f("KC01", src.path, protos[c.entry].line,
                      f"{c.entry} launches `{k}`, which its contract "
                      "does not name"))
    for k in sorted(set(c.kernels) - launched):
        if k in kernels:
            out.append(_f("KC01", src.path, protos[c.entry].line,
                          f"{c.entry}: stale contract kernel `{k}` (never "
                          "launched from the entry)"))
    return out, launches


def _check_prototype(c: KernelContract, src: CudaSource,
                     build: BuildInfo) -> List[Finding]:
    """KC02: the prototype's parameters against the ctypes argtypes."""
    proto = {p.name: p for p in src.prototypes()}.get(c.entry)
    sig = build.signatures.get(c.entry)
    if proto is None or sig is None:
        return []
    out: List[Finding] = []
    if len(proto.params) != len(sig):
        out.append(_f("KC02", src.path, proto.line,
                      f"{c.entry}: {len(proto.params)} parameters, "
                      f"build.SIGNATURES gives {len(sig)} argtypes"))
    for i, ((ctype, name), got) in enumerate(zip(proto.params, sig)):
        want = "c_void_p" if "*" in ctype else CTYPES.get(ctype)
        if want is None:
            out.append(_f("KC02", src.path, proto.line,
                          f"{c.entry}: parameter {i} `{ctype} {name}` has "
                          "no ctypes mapping"))
        elif got != want:
            out.append(_f("KC02", build.path, build.lines.get(c.entry, 1),
                          f"{c.entry}: argtype {i} is {got}, the C "
                          f"parameter `{ctype} {name}` needs {want}"))
    return out


def _check_smem(c: KernelContract, src: CudaSource,
                sources: Mapping[str, CudaSource], kernels: Iterable[str],
                smem_optin: int) -> List[Finding]:
    """KC03 for one contract: the model at the max shapes, and every
    kernel past 48 KiB raised in its source."""
    line = {p.name: p.line for p in src.prototypes()}.get(c.entry, 1)
    if c.smem_model is None or c.max_shapes is None:
        return [_f("KC03", src.path, line,
                   f"{c.entry}: contract declares no shared-memory model "
                   "/ max shapes")]
    try:
        dyn = c.max_smem_bytes()
    except (TypeError, ValueError, KeyError) as e:
        return [_f("KC03", src.path, line,
                   f"{c.entry}: smem_model does not accept the declared "
                   f"max_shapes ({e})")]
    out: List[Finding] = []
    raised: Set[str] = set()
    for s in cuda_src.include_closure(src, dict(sources)):
        for a in s.smem_attributes(set(kernels)):
            raised |= set(a.kernels)
    for k in c.kernels:
        total = dyn.get(k, 0) + int(c.static_smem.get(k, 0))
        if total > smem_optin:
            out.append(_f("KC03", src.path, line,
                          f"{c.entry}: `{k}` takes {dyn.get(k, 0)} dynamic "
                          f"+ {c.static_smem.get(k, 0)} static bytes at max "
                          f"shapes {dict(c.max_shapes)} > a block's "
                          f"{smem_optin}"))
        if dyn.get(k, 0) > DEFAULT_DYNAMIC_SMEM and k not in raised:
            out.append(_f("KC03", src.path, line,
                          f"{c.entry}: `{k}` takes {dyn.get(k, 0)} dynamic "
                          "bytes but its source never raises its "
                          "cudaFuncAttributeMaxDynamicSharedMemorySize"))
    return out


def _check_tails(c: KernelContract, src: CudaSource,
                 launches: Sequence[cuda_src.Launch],
                 kernels: Mapping[str, Tuple[CudaSource,
                                             cuda_src.Function]]
                 ) -> List[Finding]:
    """KC04: every kernel on a ceil-division or persistent grid has its
    declared guard in its body; no guard is stale."""
    out: List[Finding] = []
    guarded: Set[str] = set()
    for x in launches:
        kind = grid_kind(x.grid_expanded)
        if kind == "exact":
            continue
        for k in x.kernels:
            guarded.add(k)
            guard = c.tail.get(k)
            if guard is None:
                out.append(_f("KC04", src.path, x.line,
                              f"{c.entry}: `{k}` runs on a {kind} grid "
                              f"({x.config[0]}) with no declared tail "
                              "guard"))
    for k, guard in sorted(c.tail.items()):
        if k not in guarded:
            out.append(_f("KC04", src.path, 1,
                          f"{c.entry}: stale tail guard for `{k}` (no "
                          "ceil-division or persistent launch)"))
            continue
        if k in kernels:
            ksrc, kfn = kernels[k]
            if squash(guard) not in squash(kernel_text(ksrc, kfn)):
                out.append(_f("KC04", ksrc.path, kfn.line,
                              f"{c.entry}: declared tail guard {guard!r} "
                              f"not found in `{k}`"))
    return out


def _check_mma(c: KernelContract, src: CudaSource,
               sources: Mapping[str, CudaSource]) -> List[Finding]:
    """KC05: each tensor-core instruction the source and its headers
    hold accumulates in f32/s32, in the contract's types."""
    out: List[Finding] = []
    found: Set[str] = set()
    for s in cuda_src.include_closure(src, dict(sources)):
        for m in s.mmas:
            acc = m.accumulate
            found.add(acc)
            if acc not in MMA_ACCUM_TYPES:
                out.append(_f("KC05", s.path, m.line,
                              f"{c.entry}: `{m.text}` accumulates in "
                              f"{acc or 'no type'}, expected one of "
                              f"{MMA_ACCUM_TYPES}"))
            elif acc not in c.accumulators.mma:
                out.append(_f("KC05", s.path, m.line,
                              f"{c.entry}: `{m.text}` accumulates in {acc},"
                              " which the contract does not declare "
                              f"{tuple(c.accumulators.mma)}"))
            if c.exact_parity and "tf32" in m.types:
                out.append(_f("KC05", s.path, m.line,
                              f"{c.entry}: tf32 operand `{m.text}` in an "
                              "exact-parity source"))
    for acc in c.accumulators.mma:
        if acc not in found:
            out.append(_f("KC05", src.path, 1,
                          f"{c.entry}: stale accumulate type {acc!r} (no "
                          "such instruction in the source)"))
    return out


def _check_approx(c: KernelContract, src: CudaSource,
                  sources: Mapping[str, CudaSource]) -> List[Finding]:
    """KC07 for one contract: no approximate math anywhere its source
    (and what it includes) compiles, unless it is a flash source."""
    if not c.exact_parity:
        if c.source in INEXACT_SOURCES:
            return []
        return [_f("KC07", src.path, 1,
                   f"{c.entry}: exact_parity=False outside the flash "
                   f"attention sources {INEXACT_SOURCES}")]
    out: List[Finding] = []
    for s in cuda_src.include_closure(src, dict(sources)):
        for m in _APPROX_CALL.finditer(s.bare):
            out.append(_f("KC07", s.path, s.line_of(m.start()),
                          f"{c.entry}: approximate intrinsic "
                          f"`{m.group(1)}` reached from an exact-parity "
                          "source"))
        for m in _APPROX_PTX.finditer(s.code):
            out.append(_f("KC07", s.path, s.line_of(m.start()),
                          f"{c.entry}: PTX `.approx` reached from an "
                          "exact-parity source"))
    return out


def _check_accumulators(c: KernelContract,
                        kernels: Mapping[str, Tuple[CudaSource,
                                                    cuda_src.Function]]
                        ) -> List[Finding]:
    """KC08: each declared running accumulator is declared in its kernel
    in the contract's type, and that type is float or int."""
    out: List[Finding] = []
    for k, accs in sorted(c.accumulators.running.items()):
        if k not in kernels:
            out.append(_f("KC08", c.source, 1,
                          f"{c.entry}: accumulators declared for unknown "
                          f"kernel `{k}`"))
            continue
        ksrc, kfn = kernels[k]
        decls = declared_types(kernel_text(ksrc, kfn))
        for name, ctype in accs:
            if ctype not in ACCUMULATOR_TYPES:
                out.append(_f("KC08", ksrc.path, kfn.line,
                              f"{c.entry}: `{k}`'s accumulator `{name}` is "
                              f"declared {ctype} in the contract, not one "
                              f"of {ACCUMULATOR_TYPES}"))
            got = decls.get(name)
            if not got:
                out.append(_f("KC08", ksrc.path, kfn.line,
                              f"{c.entry}: accumulator `{name}` is not "
                              f"declared in `{k}`"))
            elif got != {ctype}:
                out.append(_f("KC08", ksrc.path, kfn.line,
                              f"{c.entry}: accumulator `{name}` of `{k}` "
                              f"is declared {sorted(got)}, the contract "
                              f"says {ctype}"))
    return out


def check_contract(c: KernelContract, sources: Mapping[str, CudaSource],
                   build: BuildInfo, smem_optin: int) -> List[Finding]:
    """Every KC rule that concerns one contract."""
    src = sources.get(c.source)
    if src is None:
        return [_f("KC01", build.path, 1,
                   f"contract for `{c.entry}` names source {c.source}, "
                   "which does not exist")]
    kernels = visible_kernels(src, sources)
    out, launches = _check_launched(c, src, kernels)
    out += _check_prototype(c, src, build)
    out += _check_smem(c, src, sources, kernels, smem_optin)
    out += _check_tails(c, src, launches, kernels)
    out += _check_mma(c, src, sources)
    out += _check_approx(c, src, sources)
    out += _check_accumulators(c, kernels)
    return out


def check_file_wide(sources: Mapping[str, CudaSource], build: BuildInfo,
                    smem_optin: int) -> List[Finding]:
    """The rules that hold for every file and the build: KC03's
    ``constexpr SMEM_MAX``, KC06's ``double``, KC07's nvcc flags."""
    out: List[Finding] = []
    for _, s in sorted(sources.items()):
        for value, line in s.smem_max:
            if value != smem_optin:
                out.append(_f("KC03", s.path, line,
                              f"constexpr SMEM_MAX = {value}, a block's "
                              f"opt-in is {smem_optin}"))
        for m in re.finditer(r"\bdouble\b", s.bare):
            out.append(_f("KC06", s.path, s.line_of(m.start()),
                          "double in a kernel source"))
    for flag in build.nvcc_flags:
        if flag in FAST_MATH_FLAGS:
            out.append(_f("KC07", build.path, 1,
                          f"build.NVCC_FLAGS holds {flag}"))
    return out


def check_sources(sources: Mapping[str, CudaSource], build: BuildInfo,
                  contracts: Sequence[KernelContract],
                  smem_optin: int) -> List[Finding]:
    """All KC rules over parsed sources, a build and the contracts."""
    out = _check_registry(sources, build, contracts)
    for c in contracts:
        out += check_contract(c, sources, build, smem_optin)
    out += check_file_wide(sources, build, smem_optin)
    return out


def kernels_dir(root: Path) -> Path:
    """``src/repro_torch/kernels`` under the checkout ``root``."""
    return Path(root) / "src" / "repro_torch" / "kernels"


def check_kernels(root: Path, registry, smem_optin: int,
                  build: Optional[BuildInfo] = None) -> List[Finding]:
    """KC rules over ``src/repro_torch/kernels/csrc/`` and ``build.py``
    of the checkout at ``root``."""
    kdir = kernels_dir(root)
    build = build or read_build(kdir / "build.py")
    sources = cuda_src.load_dir(kdir / "csrc")
    contracts = list(registry.values()) if isinstance(registry, dict) \
        else list(registry)
    return check_sources(sources, build, contracts, smem_optin)
