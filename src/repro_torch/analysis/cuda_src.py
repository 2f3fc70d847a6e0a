"""A lexical reader of one CUDA source (``.cu`` / ``.cuh``).

The counterpart of the JAX package's ``find_pallas_sites``: it finds,
in the text alone (nothing is compiled or run), what the KC rules hold
against the contracts:

* each ``extern "C"`` entry, with its parameters' types;
* each ``__global__`` definition: name, line, template parameters,
  ``__launch_bounds__`` and body;
* each ``<<<grid, block, smem, stream>>>`` launch, with the kernel it
  launches and the function that holds it;
* each ``cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize,
  ...)``, directly or through a helper that forwards its parameter;
* each ``mma.sync`` / ``wgmma.mma_async`` instruction string;
* each ``#include "..."`` and each ``constexpr ... SMEM_MAX = N``.

Comments are blanked to spaces (line numbers stay); :attr:`CudaSource.code`
keeps string literals (the ``asm`` text), :attr:`CudaSource.bare` blanks
them and the preprocessor lines too, so braces and names are read from
code only.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

_IDENT = re.compile(r"[A-Za-z_]\w*")
# identifiers followed by "(" that are attributes, not a function's name
_ATTRIBUTES = frozenset({"__launch_bounds__", "__align__", "alignas",
                         "__attribute__", "__declspec", "decltype"})
_CONTROL = frozenset({"if", "for", "while", "switch", "catch", "do",
                      "else", "return", "sizeof"})
_TYPE_HEADS = re.compile(r"\b(namespace|struct|class|union|enum)\b")
_MMA = re.compile(r"\b(w?gmma\.mma_async[\w.]*|mma\.sync[\w.]*)")
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)
_SMEM_MAX = re.compile(
    r"\bconstexpr\b[^;=]*\bSMEM_MAX\s*=\s*([0-9][0-9_']*)[uUlL]*\s*;")


@dataclasses.dataclass
class Prototype:
    """One ``extern "C"`` entry: its name, line and parameters (type
    text without the name, and the name)."""

    name: str
    line: int
    params: List[Tuple[str, str]]


@dataclasses.dataclass
class Function:
    """A function defined at namespace scope."""

    name: str
    line: int
    header: str               # the text before the body's brace
    params: List[str]         # parameter names
    body_start: int           # offset of "{"
    body_end: int             # offset after the matching "}"
    is_global: bool
    is_extern_c: bool
    template: Optional[str]
    launch_bounds: Optional[str]


@dataclasses.dataclass
class Launch:
    """One ``callee<<<config>>>`` launch."""

    callee: str               # the name before <<< (template args cut)
    kernels: Tuple[str, ...]  # the __global__ kernels it may launch
    line: int
    config: List[str]         # grid, block[, smem[, stream]]
    grid_expanded: str        # the grid with one level of locals resolved
    function: str             # the function that holds it


@dataclasses.dataclass
class SmemAttribute:
    """One raise of a kernel's dynamic shared-memory limit."""

    kernels: Tuple[str, ...]
    line: int
    function: str


@dataclasses.dataclass
class MmaInstr:
    """One tensor-core instruction string."""

    text: str
    line: int

    @property
    def accumulate(self) -> str:
        """The accumulator (D) type: the first type suffix after the
        shape (and, for ``mma.sync``, the two layouts)."""
        types = [p for p in self.text.split(".")
                 if p in _PTX_TYPES]
        return types[0] if types else ""

    @property
    def types(self) -> List[str]:
        return [p for p in self.text.split(".") if p in _PTX_TYPES]


_PTX_TYPES = frozenset({"f16", "bf16", "tf32", "f32", "f64", "s8", "u8",
                        "s4", "u4", "b1", "s32", "e4m3", "e5m2", "f16x2"})


def _blank(text: str) -> Tuple[str, str]:
    """(code, bare): comments blanked; in ``bare`` also the contents of
    string and character literals and every preprocessor line (with its
    continuations).  Newlines are kept, so offsets keep their lines."""
    code, bare = list(text), list(text)
    i, n = 0, len(text)
    at_line_start = True
    while i < n:
        c = text[i]
        if at_line_start and c == "#":
            # a preprocessor directive: blank it in bare to its end
            j = i
            while j < n:
                if text[j] == "\n" and text[j - 1] != "\\":
                    break
                j += 1
            for p in range(i, j):
                if text[p] != "\n":
                    bare[p] = " "
            # comments inside it are still blanked in code
            seg = text[i:j]
            for m in re.finditer(r"//[^\n]*|/\*.*?\*/", seg, re.S):
                for p in range(i + m.start(), i + m.end()):
                    if text[p] != "\n":
                        code[p] = " "
            i = j
            continue
        if c == "\n":
            at_line_start = True
            i += 1
            continue
        if not c.isspace():
            at_line_start = False
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            for p in range(i, j):
                code[p] = bare[p] = " "
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            for p in range(i, j):
                if text[p] != "\n":
                    code[p] = bare[p] = " "
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            for p in range(i + 1, min(j, n)):
                if text[p] != "\n":
                    bare[p] = " "
            i = j + 1
        else:
            i += 1
    return "".join(code), "".join(bare)


def _match(text: str, i: int, open_c: str, close_c: str) -> int:
    """Offset after the bracket closing the one at ``text[i]``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_c:
            depth += 1
        elif text[j] == close_c:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def split_top(text: str, sep: str = ",") -> List[str]:
    """``text`` split at ``sep`` outside (), [], {} and <...> nesting."""
    out, depth, cur = [], 0, []
    angle = 0
    for c in text:
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        elif c == "<" and depth == 0:
            angle += 1
        elif c == ">" and depth == 0 and angle:
            angle -= 1
        if c == sep and depth == 0 and angle == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    tail = "".join(cur)
    if tail.strip() or out:
        out.append(tail)
    return [s.strip() for s in out]


def squash(s: str) -> str:
    """``s`` with all whitespace removed."""
    return "".join(s.split())


class CudaSource:
    """One parsed ``.cu`` / ``.cuh`` file."""

    def __init__(self, path):
        self.path = Path(path)
        self.text = self.path.read_text()
        self.code, self.bare = _blank(self.text)
        self._line_starts = [0] + [m.end() for m in
                                   re.finditer("\n", self.text)]
        self.functions: Dict[str, List[Function]] = {}
        self._scan(0, len(self.bare))
        self.includes: List[Tuple[str, int]] = [
            (m.group(1), self.line_of(m.start()))
            for m in _INCLUDE.finditer(self.code)]
        self.smem_max: List[Tuple[int, int]] = [
            (int(m.group(1).replace("_", "").replace("'", "")),
             self.line_of(m.start()))
            for m in _SMEM_MAX.finditer(self.bare)]
        self.mmas: List[MmaInstr] = [
            MmaInstr(m.group(1).rstrip("."), self.line_of(m.start()))
            for m in _MMA.finditer(self._strings_only())]

    # ------------------------------------------------------------ basics
    def line_of(self, offset: int) -> int:
        """1-based line of ``offset``."""
        lo, hi = 0, len(self._line_starts) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._line_starts[mid] <= offset:
                lo = mid
            else:
                hi = mid - 1
        return lo + 1

    def _strings_only(self) -> str:
        """``code`` with everything outside string literals blanked."""
        out = [" " if c != "\n" else "\n" for c in self.code]
        i, n = 0, len(self.code)
        while i < n:
            if self.bare[i] == '"' and self.code[i] == '"':
                j = i + 1
                while j < n and not (self.bare[j] == '"'):
                    j += 1
                for p in range(i + 1, j):
                    out[p] = self.code[p]
                i = j + 1
            else:
                i += 1
        return "".join(out)

    # ------------------------------------------------------- functions
    def _scan(self, start: int, end: int) -> None:
        """Find the function definitions between ``start`` and ``end`` at
        namespace scope (``namespace`` and ``extern "C"`` blocks are
        walked into; types and initialisers are skipped whole)."""
        b = self.bare
        i, head_start = start, start
        while i < end:
            c = b[i]
            if c in ";}":
                head_start = i + 1
                i += 1
            elif c == "(":
                i = _match(b, i, "(", ")")
            elif c == "{":
                close = _match(b, i, "{", "}")
                header = b[head_start:i]
                words = set(_IDENT.findall(header))
                if "namespace" in words or squash(header) == 'extern""':
                    self._scan(i + 1, close - 1)
                elif not _TYPE_HEADS.search(header) and "=" not in \
                        header.split("(")[0]:
                    self._function(header, head_start, i, close)
                i = close
                head_start = i
            else:
                i += 1

    def _function(self, header: str, h0: int, body: int, end: int) -> None:
        name, params, p_open = None, [], None
        for m in re.finditer(r"([A-Za-z_]\w*)\s*\(", header):
            if m.group(1) in _ATTRIBUTES:
                continue
            depth = header[:m.start()].count("(") - \
                header[:m.start()].count(")")
            if depth:
                continue
            name, p_open = m.group(1), h0 + m.end() - 1
            break
        if name is None or name in _CONTROL:
            return
        p_close = _match(self.bare, p_open, "(", ")")
        params = [_param_name(p) for p in
                  split_top(self.bare[p_open + 1:p_close - 1])]
        raw_header = self.code[h0:body]
        tmpl = re.search(r"\btemplate\s*<(.*?)>\s*(?:__global__|static|"
                         r"__device__|__host__|inline|void|int|bool|"
                         r"cudaError_t|auto|extern|[A-Za-z_])", header,
                         re.S)
        lb = re.search(r"__launch_bounds__\s*\(([^)]*)\)", header)
        fn = Function(
            name=name, line=self.line_of(h0 + len(header)
                                         - len(header.lstrip())),
            header=header.strip(), params=[p for p in params if p],
            body_start=body, body_end=end,
            is_global=bool(re.search(r"\b__global__\b", header)),
            is_extern_c=bool(re.search(r'\bextern\s*"C"', raw_header)),
            template=tmpl.group(1).strip() if tmpl else None,
            launch_bounds=lb.group(1).strip() if lb else None)
        self.functions.setdefault(name, []).append(fn)

    def all_functions(self) -> List[Function]:
        return [f for fs in self.functions.values() for f in fs]

    def globals(self) -> List[Function]:
        """Every ``__global__`` definition, in source order."""
        return sorted((f for f in self.all_functions() if f.is_global),
                      key=lambda f: f.body_start)

    def body(self, fn: Function) -> str:
        """The bare text of ``fn``'s body."""
        return self.bare[fn.body_start:fn.body_end]

    def prototypes(self) -> List[Prototype]:
        """Every ``extern "C"`` entry defined here, in source order."""
        out = []
        for fn in sorted(self.all_functions(), key=lambda f: f.body_start):
            if not fn.is_extern_c:
                continue
            p_open = self.bare.index("(", self.bare.rfind(
                fn.name, 0, fn.body_start))
            p_close = _match(self.bare, p_open, "(", ")")
            params = [(_param_type(p), _param_name(p)) for p in
                      split_top(self.bare[p_open + 1:p_close - 1])
                      if p and p != "void"]
            out.append(Prototype(fn.name, fn.line, params))
        return out

    # -------------------------------------------------------- launches
    def _locals(self, fn: Function) -> Dict[str, str]:
        """name -> initialiser of the simple local declarations and
        assignments in ``fn`` (``auto k = ...;``, ``const int a = ...,
        b = ...;``, ``dim3 grid(...);``): one level, as
        ``astutil.local_env``."""
        env: Dict[str, str] = {}
        for stmt in re.split(r"[;{}]", self.body(fn)):
            s = stmt.strip()
            if re.match(r"(if|for|while|return|switch|case)\b", s):
                continue
            m = re.match(r"(?:const\s+)?dim3\s+([A-Za-z_]\w*)\s*[({](.*)[)}]$",
                         s, re.S)
            if m:
                env.setdefault(m.group(1), f"dim3({m.group(2).strip()})")
                continue
            for part in split_top(s):
                m = re.match(r"(?:[\w:<>*&\s]*?[\s*&])?([A-Za-z_]\w*)\s*"
                             r"=(?!=)\s*(.+)$", part, re.S)
                if m:
                    env.setdefault(m.group(1), m.group(2).strip())
        return env

    @staticmethod
    def _target_name(expr: str) -> str:
        """The name a kernel expression refers to, casts and template
        arguments cut: ``(const void*)k<T, 1>`` -> ``k``."""
        head = expr.split("<")[0]
        names = _IDENT.findall(head)
        return names[-1] if names else ""

    def _resolve_kernels(self, name: str, fn: Function,
                         kernels: Set[str]) -> Tuple[str, ...]:
        if name in kernels:
            return (name,)
        init = self._locals(fn).get(name, "")
        return tuple(sorted({w for w in _IDENT.findall(init)
                             if w in kernels}))

    def launches(self, kernels: Set[str]) -> List[Launch]:
        """Every ``<<<...>>>`` launch; ``kernels`` are the ``__global__``
        names visible here (this file's and its headers')."""
        out = []
        for fn in self.all_functions():
            body = self.body(fn)
            for m in re.finditer(r"([A-Za-z_][\w:]*)\s*(<[^;{}]*?>)?\s*<<<",
                                 body):
                cfg_start = fn.body_start + m.end()
                cfg_end = self.bare.find(">>>", cfg_start)
                config = split_top(self.bare[cfg_start:cfg_end])
                grid = config[0] if config else ""
                expanded = self._expand(grid, fn)
                callee = m.group(1).split("::")[-1]
                out.append(Launch(
                    callee=callee,
                    kernels=self._resolve_kernels(callee, fn, kernels),
                    line=self.line_of(fn.body_start + m.start()),
                    config=config, grid_expanded=expanded,
                    function=fn.name))
        return sorted(out, key=lambda x: x.line)

    def _expand(self, expr: str, fn: Function, depth: int = 4) -> str:
        """``expr`` with each of ``fn``'s locals replaced by its
        initialiser (one level), and each parameter by the arguments that
        the callers pass, resolved the same way in each caller (up to
        ``depth`` callers up)."""
        env = self._locals(fn)

        def sub(w):
            name = w.group(0)
            if name in env:
                return f"({env[name]})"
            if name in fn.params and depth > 0:
                args = [self._expand(a, caller, depth - 1) for caller, a in
                        self._call_args(fn.name, fn.params.index(name))]
                if args:
                    return "(" + " | ".join(sorted(set(args))) + ")"
            return name
        return re.sub(r"\b[A-Za-z_]\w*\b", sub, expr)

    def _call_args(self, callee: str, pos: int
                   ) -> List[Tuple[Function, str]]:
        """(caller, argument) of the ``pos``-th argument of every call of
        ``callee`` in this file."""
        out = []
        for fn in self.all_functions():
            if fn.name == callee:
                continue
            body = self.body(fn)
            for m in re.finditer(rf"\b{re.escape(callee)}\s*"
                                 r"(<[^;{}()]*?>)?\s*\(", body):
                p_open = fn.body_start + m.end() - 1
                args = split_top(self.bare[p_open + 1:_match(
                    self.bare, p_open, "(", ")") - 1])
                if pos < len(args):
                    out.append((fn, args[pos]))
        return out

    def smem_attributes(self, kernels: Set[str]) -> List[SmemAttribute]:
        """Every raise of the dynamic shared-memory limit, followed
        through helpers that pass their parameter on."""
        direct: List[Tuple[Function, str, int]] = []
        for fn in self.all_functions():
            body = self.body(fn)
            for m in re.finditer(r"\bcudaFuncSetAttribute\s*\(", body):
                p_open = fn.body_start + m.end() - 1
                args = split_top(self.bare[p_open + 1:_match(
                    self.bare, p_open, "(", ")") - 1])
                if len(args) >= 2 and \
                        "cudaFuncAttributeMaxDynamicSharedMemorySize" \
                        in args[1]:
                    direct.append((fn, args[0],
                                   self.line_of(fn.body_start + m.start())))
        out: List[SmemAttribute] = []
        for fn, target, line in direct:
            target = self._target_name(target)
            if target in fn.params:
                # a helper: each call passes the kernel at that position
                pos = fn.params.index(target)
                out += self._helper_calls(fn.name, pos, kernels)
            else:
                out.append(SmemAttribute(
                    self._resolve_kernels(target, fn, kernels), line,
                    fn.name))
        return out

    def _helper_calls(self, helper: str, pos: int,
                      kernels: Set[str]) -> List[SmemAttribute]:
        out = []
        for fn in self.all_functions():
            if fn.name == helper:
                continue
            body = self.body(fn)
            for m in re.finditer(rf"\b{re.escape(helper)}\s*\(", body):
                p_open = fn.body_start + m.end() - 1
                args = split_top(self.bare[p_open + 1:_match(
                    self.bare, p_open, "(", ")") - 1])
                if pos < len(args):
                    target = self._target_name(args[pos])
                    out.append(SmemAttribute(
                        self._resolve_kernels(target, fn, kernels),
                        self.line_of(fn.body_start + m.start()), fn.name))
        return out

    # ------------------------------------------------------ call graph
    def calls(self, fn: Function) -> Set[str]:
        """Names of this file's functions that ``fn``'s body names."""
        names = set(self.functions)
        return {w for w in _IDENT.findall(self.body(fn))
                if w in names and w != fn.name}

    def reachable(self, entry: str) -> Set[str]:
        """Every function of this file reachable from ``entry``
        (inclusive), by the names the bodies mention."""
        seen, todo = {entry}, [entry]
        while todo:
            cur = todo.pop()
            for fn in self.functions.get(cur, []):
                for nxt in self.calls(fn):
                    if nxt not in seen:
                        seen.add(nxt)
                        todo.append(nxt)
        return seen


def _param_name(p: str) -> str:
    p = re.sub(r"=.*$", "", p).strip()
    p = re.sub(r"\[[^\]]*\]\s*$", "", p).strip()
    m = re.search(r"([A-Za-z_]\w*)\s*$", p)
    if not m:
        return ""
    words = p.split()
    if len(words) == 1 and "*" not in p and "&" not in p:
        return ""            # a type with no name
    return m.group(1)


def _param_type(p: str) -> str:
    """A parameter's type text with its name and ``const`` cut."""
    p = re.sub(r"=.*$", "", p).strip()
    name = _param_name(p)
    if name and p.endswith(name):
        p = p[:-len(name)]
    p = re.sub(r"\b(const|volatile|__restrict__|restrict)\b", " ", p)
    p = re.sub(r"\s*\*\s*", "*", p)
    return " ".join(p.split())


def include_closure(src: CudaSource,
                    sources: Dict[str, CudaSource]) -> List[CudaSource]:
    """``src`` and every header of ``sources`` it includes, transitively
    (system headers, not in ``sources``, are skipped)."""
    out, seen, todo = [], {src.path.name}, [src]
    while todo:
        cur = todo.pop(0)
        out.append(cur)
        for name, _ in cur.includes:
            if name in sources and name not in seen:
                seen.add(name)
                todo.append(sources[name])
    return out


def load_dir(csrc: Path) -> Dict[str, CudaSource]:
    """Every ``.cu`` / ``.cuh`` under ``csrc``, by file name."""
    paths = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    return {p.name: CudaSource(p) for p in paths}
