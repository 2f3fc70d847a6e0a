"""Stdlib-``ast`` plumbing shared by the OR and EN rule modules.

Pure syntax: nothing here imports torch or executes repo code.  The
port's copy of the JAX package's ``repro/analysis/astutil.py`` without
its ``pl.pallas_call`` site extraction (``cuda_src`` reads the CUDA
sources instead): local-name chasing, referenced names, raw durable
writes, the call graph the EN01 rule walks, and the normalized
function-body comparison of the intentional-duplicate rule (OR03),
which canonicalizes ``cdiv(a, b)`` to ``-(-a // b)`` and strips
docstrings so the two legal spellings of ceil-div compare equal.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Optional, Set


@dataclasses.dataclass
class SourceFile:
    """A parsed file: path, raw text, module AST."""

    path: Path
    text: str
    tree: ast.Module


def load(path) -> SourceFile:
    """Parse ``path`` into a :class:`SourceFile`."""
    p = Path(path)
    text = p.read_text()
    return SourceFile(path=p, text=text, tree=ast.parse(text))


def top_level_functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    """Module-level function definitions by name (classes excluded)."""
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def local_env(fn: ast.AST) -> Dict[str, ast.expr]:
    """name -> value for simple single-target assignments under ``fn``.

    Shallow by design: used to chase one-hop indirections, not to
    evaluate code.
    """
    env: Dict[str, ast.expr] = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            env[node.targets[0].id] = node.value
    return env


def resolve(expr: Optional[ast.expr], env: Dict[str, ast.expr],
            depth: int = 4) -> Optional[ast.expr]:
    """Follow Name -> assigned-value links up to ``depth`` hops."""
    while (depth and isinstance(expr, ast.Name) and expr.id in env
           and env[expr.id] is not expr):
        expr = env[expr.id]
        depth -= 1
    return expr


def _called_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def referenced_names(fn: ast.AST) -> Set[str]:
    """Every name referenced under ``fn``: bare names as ``name``,
    one-level attribute access as ``base.attr`` (plus bare ``attr``
    for deeper chains).  Nested defs/lambdas fold in automatically."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name):
                out.add(f"{node.value.id}.{node.attr}")
            else:
                out.add(node.attr)
    return out


def writes_raw(fn: ast.AST) -> bool:
    """True when ``fn`` performs a raw durable write: ``open`` in a
    writable mode, ``os.replace``, or ``np.savez*``/``np.save``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (isinstance(f, ast.Name) and f.id == "open"
                and len(node.args) >= 2):
            mode = node.args[1]
            if (isinstance(mode, ast.Constant)
                    and isinstance(mode.value, str)
                    and any(c in mode.value for c in "wa+x")):
                return True
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id == "os" and f.attr == "replace":
                return True
            if f.value.id in ("np", "numpy") and (
                    f.attr.startswith("savez") or f.attr == "save"):
                return True
    return False


class _CdivNormalizer(ast.NodeTransformer):
    """Rewrite ``cdiv(a, b)`` / ``pl.cdiv(a, b)`` to ``-(-a // b)``."""

    def visit_Call(self, node: ast.Call) -> ast.expr:
        self.generic_visit(node)
        if (_called_name(node.func) == "cdiv" and len(node.args) == 2
                and not node.keywords):
            a, b = node.args
            return ast.UnaryOp(
                op=ast.USub(),
                operand=ast.BinOp(
                    left=ast.UnaryOp(op=ast.USub(), operand=a),
                    op=ast.FloorDiv(), right=b))
        return node


def normalized_body_dump(fn: ast.FunctionDef) -> str:
    """Deterministic dump of ``fn``'s body, docstring stripped and
    ceil-div spellings canonicalized — signatures are NOT compared, so
    duplicates may legally differ in defaults/annotations (OR03)."""
    body = list(fn.body)
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        body = body[1:]
    module = ast.Module(body=body, type_ignores=[])
    module = _CdivNormalizer().visit(module)
    return ast.dump(module, annotate_fields=False)


@dataclasses.dataclass
class FuncInfo:
    """A function at module or class scope, for call-graph rules."""

    qualname: str
    node: ast.FunctionDef
    cls: Optional[str] = None


def collect_functions(tree: ast.Module) -> Dict[str, FuncInfo]:
    """Module-level functions plus class methods (``Cls.meth``).

    Nested defs are folded into their enclosing function by the
    ``ast.walk``-based predicates, so the graph stays at this
    granularity on purpose.
    """
    out: Dict[str, FuncInfo] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = FuncInfo(qualname=node.name, node=node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{node.name}.{sub.name}"
                    out[q] = FuncInfo(qualname=q, node=sub, cls=node.name)
    return out


def call_edges(funcs: Dict[str, FuncInfo]) -> Dict[str, Set[str]]:
    """qualname -> qualnames it references (module-local resolution:
    bare names to module functions, ``self.x`` to same-class methods)."""
    edges: Dict[str, Set[str]] = {}
    module_level = {q for q, f in funcs.items() if f.cls is None}
    for q, info in funcs.items():
        refs = referenced_names(info.node)
        tgt: Set[str] = set()
        for r in refs:
            if r in module_level:
                tgt.add(r)
            if r.startswith("self."):
                meth = f"{info.cls}.{r[5:]}"
                if meth in funcs:
                    tgt.add(meth)
        tgt.discard(q)
        edges[q] = tgt
    return edges


def transitive_closure(start: str,
                       edges: Dict[str, Set[str]]) -> Set[str]:
    """Every qualname reachable from ``start`` (inclusive)."""
    seen = {start}
    frontier = [start]
    while frontier:
        cur = frontier.pop()
        for nxt in edges.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return seen


def module_for(root: Path, path: Path) -> str:
    """Dotted module name of ``path`` under ``root/src``."""
    rel = path.resolve().relative_to((root / "src").resolve())
    return ".".join(rel.with_suffix("").parts)


def path_for(root: Path, module: str) -> Path:
    """Source path of dotted ``module`` under ``root/src``."""
    return root / "src" / Path(*module.split(".")).with_suffix(".py")
