"""Rule family (b): dispatcher/oracle pairing (OR01–OR03).

The port's copy of the JAX package's rules, over the port's own files:
every public dispatcher in ``repro_torch.kernels.ops`` must reach a
plain version in ``repro_torch.kernels.ref`` (OR01), at least one
``tests/test_torch_*.py`` file must exercise the dispatcher (or its
kernel module) against that plain version (OR02), and intentionally
duplicated helper bodies must stay AST-identical across modules (OR03).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.report import Finding


def _f(rule: str, path: Path, line: int, msg: str) -> Finding:
    return Finding(rule=rule, path=str(path), line=line, message=msg)


def _has_impl_arg(fn: ast.FunctionDef) -> bool:
    """True for an ``impl=None`` selector argument (the dispatcher
    signature convention — distinguishes dispatchers from helpers like
    ``default_impl(impl)`` that take a required impl string)."""
    args = fn.args
    for i, a in enumerate(args.args):
        if a.arg != "impl":
            continue
        j = i - (len(args.args) - len(args.defaults))
        return (0 <= j < len(args.defaults)
                and isinstance(args.defaults[j], ast.Constant)
                and args.defaults[j].value is None)
    for i, a in enumerate(args.kwonlyargs):
        if a.arg != "impl":
            continue
        d = args.kw_defaults[i]
        return isinstance(d, ast.Constant) and d.value is None
    return False


def public_dispatchers(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    """Public top-level functions taking an ``impl`` argument."""
    return {name: fn
            for name, fn in astutil.top_level_functions(tree).items()
            if not name.startswith("_") and _has_impl_arg(fn)}


def kernel_import_aliases(tree: ast.Module) -> Dict[str, str]:
    """local-alias -> original name for ``repro_torch.kernels.*``
    imports (the ``ref``/``work``/``build`` helper modules themselves
    excluded)."""
    out: Dict[str, str] = {}
    for node in tree.body:
        if not isinstance(node, ast.ImportFrom):
            continue
        mod = node.module or ""
        if not mod.startswith("repro_torch.kernels"):
            continue
        for alias in node.names:
            if alias.name in ("ref", "work", "build"):
                continue
            out[alias.asname or alias.name] = alias.name
    return out


def _ops_closure(name: str, ops_funcs: Dict[str, ast.FunctionDef],
                 cache: Dict[str, Set[str]]) -> Set[str]:
    """Names referenced from ``name`` through ops-local helpers.

    Reference-based, not call-based: a dispatcher that selects its
    helpers in a conditional expression is followed too.
    """
    if name in cache:
        return cache[name]
    cache[name] = set()  # cycle guard
    refs = astutil.referenced_names(ops_funcs[name])
    out = set(refs)
    for r in refs:
        if r != name and r in ops_funcs:
            out |= _ops_closure(r, ops_funcs, cache)
    cache[name] = out
    return out


def _oracle_closure(start: Iterable[str],
                    ref_funcs: Dict[str, ast.FunctionDef]) -> Set[str]:
    """Oracles reachable from ``start`` through ref-module references
    (one plain version built on another counts as both)."""
    seen: Set[str] = set()
    frontier = [s for s in start if s in ref_funcs]
    while frontier:
        cur = frontier.pop()
        if cur in seen:
            continue
        seen.add(cur)
        for r in astutil.referenced_names(ref_funcs[cur]):
            if r in ref_funcs and r not in seen:
                frontier.append(r)
    return seen


def check_dispatchers_in_tree(
        tree: ast.Module, path: Path, ref_names: Set[str],
        tests: Optional[Dict[Path, str]] = None,
        ref_funcs: Optional[Dict[str, ast.FunctionDef]] = None,
) -> List[Finding]:
    """OR01 (+OR02 when ``tests`` is given) over one ops-like module."""
    findings: List[Finding] = []
    ops_funcs = astutil.top_level_functions(tree)
    aliases = kernel_import_aliases(tree)
    cache: Dict[str, Set[str]] = {}
    for name, fn in sorted(public_dispatchers(tree).items()):
        refs = _ops_closure(name, ops_funcs, cache)
        oracles: Set[str] = set()
        for r in refs:
            if r.startswith("ref."):
                target = r[4:]
                if target in ref_names:
                    oracles.add(target)
                else:
                    findings.append(_f(
                        "OR01", path, fn.lineno,
                        f"{name}: references unknown oracle "
                        f"`ref.{target}`"))
        if not oracles:
            findings.append(_f(
                "OR01", path, fn.lineno,
                f"dispatcher `{name}` reaches no `ref.*` oracle"))
            continue
        if tests is None:
            continue
        if ref_funcs is not None:
            oracles = _oracle_closure(oracles, ref_funcs)
        kernel_names = {aliases[r] for r in refs if r in aliases}
        dispatch_side = {name} | kernel_names
        if not _covered_by_tests(dispatch_side, oracles, tests):
            findings.append(_f(
                "OR02", path, fn.lineno,
                f"no test references `{name}` (or its kernels "
                f"{sorted(kernel_names)}) together with an oracle in "
                f"{sorted(oracles)}"))
    return findings


def _covered_by_tests(dispatch_side: Set[str], oracles: Set[str],
                      tests: Dict[Path, str]) -> bool:
    for text in tests.values():
        if any(re.search(rf"\b{re.escape(n)}\b", text)
               for n in dispatch_side) and \
           any(re.search(rf"\b{re.escape(o)}\b", text)
               for o in oracles):
            return True
    return False


def check_oracle_pairing(root: Path) -> List[Finding]:
    """OR01/OR02 over the port's ``ops.py`` / ``ref.py`` and
    ``tests/test_torch_*.py``."""
    ops_path = root / "src" / "repro_torch" / "kernels" / "ops.py"
    ref_path = root / "src" / "repro_torch" / "kernels" / "ref.py"
    ops_sf = astutil.load(ops_path)
    ref_funcs = astutil.top_level_functions(astutil.load(ref_path).tree)
    tests = {p: p.read_text()
             for p in sorted((root / "tests").glob("test_torch_*.py"))}
    return check_dispatchers_in_tree(
        ops_sf.tree, ops_path, set(ref_funcs), tests=tests,
        ref_funcs=ref_funcs)


def check_duplicate_pair(
        a: Tuple[Path, str], b: Tuple[Path, str]) -> List[Finding]:
    """OR03 over one intentional-duplicate pair of (path, func name)."""
    dumps = []
    for path, name in (a, b):
        fn = astutil.top_level_functions(astutil.load(path).tree).get(name)
        if fn is None:
            return [_f("OR03", path, 1,
                       f"duplicate-pair function `{name}` not found")]
        dumps.append((path, fn.lineno, astutil.normalized_body_dump(fn)))
    if dumps[0][2] != dumps[1][2]:
        path, line, _ = dumps[1]
        return [_f("OR03", path, line,
                   f"body of `{b[1]}` has drifted from `{a[1]}` in "
                   f"{a[0]}")]
    return []


def check_duplicates(root: Path, pairs) -> List[Finding]:
    """OR03 over every registered intentional-duplicate pair."""
    findings: List[Finding] = []
    for (mod_a, fn_a), (mod_b, fn_b) in pairs:
        findings += check_duplicate_pair(
            (astutil.path_for(root, mod_a), fn_a),
            (astutil.path_for(root, mod_b), fn_b))
    return findings
