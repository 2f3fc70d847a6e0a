"""Rule family (c): engine invariants (EN01–EN03), on the port.

The port's copy of the JAX package's rules, over
``src/repro_torch/streaming/``.  EN01: every public state-store/engine
path that performs a raw durable write must reach the single atomic
LATEST commit site (``atomic_write_json``) — a write path that bypasses
it can leave a torn manifest after a crash.  Background writer threads
are held to the same discipline regardless of visibility: a
``threading.Thread`` whose ``target`` transitively writes raw without
reaching the commit sink is flagged even from a private spawner,
because the thread outlives its caller and so escapes any public path's
commit reasoning.  EN02: fault-injection site names form a closed
registry — a ``trip("...")`` with an unregistered name silently never
fires, so the chaos suite stops covering that crash window.  EN03: a
BENCH file's summary keys must follow the naming convention
``bench_schema`` classifies, or a trend gate cannot tell a gated metric
from an informational one.
"""
from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.bench_schema import classify_summary_key
from repro_torch.analysis.report import Finding

# The one function allowed to write the LATEST manifest; reaching it is
# what makes a durable-write path "committed".
COMMIT_SINK = "atomic_write_json"


def _f(rule: str, path: Path, line: int, msg: str) -> Finding:
    return Finding(rule=rule, path=str(path), line=line, message=msg)


def _is_public(qualname: str) -> bool:
    return not any(part.startswith("_") for part in qualname.split("."))


def _thread_target(node: ast.Call) -> Optional[ast.expr]:
    """The ``target=`` expression of a ``threading.Thread(...)`` call."""
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id",
                                                               None)
    if name != "Thread":
        return None
    for kw in node.keywords:
        if kw.arg == "target":
            return kw.value
    return None


def _target_qualname(expr: ast.expr, cls: Optional[str],
                     funcs: Dict[str, "astutil.FuncInfo"]) -> Optional[str]:
    """Resolve a thread target to a module-local qualname, or None."""
    if isinstance(expr, ast.Name) and expr.id in funcs:
        return expr.id
    if (isinstance(expr, ast.Attribute) and cls is not None
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and f"{cls}.{expr.attr}" in funcs):
        return f"{cls}.{expr.attr}"
    return None


def _reaches_commit(reach: Set[str], funcs: Dict[str, "astutil.FuncInfo"],
                    commit_names: Set[str]) -> bool:
    """True when any function in ``reach`` hits the commit sink —
    as a module-local definition or an imported name."""
    if reach & commit_names:
        return True
    return any(COMMIT_SINK in astutil.referenced_names(funcs[q].node)
               for q in reach if q in funcs)


def check_commit_paths_in_tree(tree: ast.Module,
                               path: Path) -> List[Finding]:
    """EN01 over one parsed module."""
    findings: List[Finding] = []
    funcs = astutil.collect_functions(tree)
    edges = astutil.call_edges(funcs)
    writers = {q for q, info in funcs.items()
               if q != COMMIT_SINK and q.rsplit(".", 1)[-1] != COMMIT_SINK
               and astutil.writes_raw(info.node)}
    if not writers:
        return findings
    commit_names = {q for q in funcs
                    if q.rsplit(".", 1)[-1] == COMMIT_SINK}
    for q, info in sorted(funcs.items()):
        if not _is_public(q):
            continue
        reach = astutil.transitive_closure(q, edges)
        if not reach & writers:
            continue
        if not _reaches_commit(reach, funcs, commit_names):
            findings.append(_f(
                "EN01", path, info.node.lineno,
                f"public `{q}` reaches a raw durable write "
                f"({sorted(reach & writers)}) without reaching the "
                f"atomic commit site `{COMMIT_SINK}`"))
    # Thread targets: the spawned function escapes every synchronous
    # call path's commit reasoning, so it is held to the discipline
    # directly — private spawners included.
    for q, info in sorted(funcs.items()):
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            target = _thread_target(node)
            if target is None:
                continue
            tq = _target_qualname(target, info.cls, funcs)
            if tq is None:
                continue
            reach = astutil.transitive_closure(tq, edges)
            if not reach & writers:
                continue
            if not _reaches_commit(reach, funcs, commit_names):
                findings.append(_f(
                    "EN01", path, node.lineno,
                    f"`{q}` spawns a thread on `{tq}`, which reaches a "
                    f"raw durable write ({sorted(reach & writers)}) "
                    f"without reaching the atomic commit site "
                    f"`{COMMIT_SINK}`"))
    return findings


def check_commit_paths(root: Path) -> List[Finding]:
    """EN01 over the streaming state-store, engine, and async-writer
    modules."""
    findings: List[Finding] = []
    for rel in ("streaming/state_store.py", "streaming/engine.py",
                "streaming/async_checkpoint.py"):
        path = root / "src" / "repro_torch" / rel
        if path.exists():
            sf = astutil.load(path)
            findings += check_commit_paths_in_tree(sf.tree, path)
    return findings


def _resolve_tuple(expr: ast.expr,
                   env: Dict[str, ast.expr]) -> Tuple[str, ...]:
    """Evaluate a registry expression: string-tuple literals plus
    ``NAME + (...)`` concatenation."""
    if isinstance(expr, ast.Name) and expr.id in env:
        return _resolve_tuple(env[expr.id], env)
    if isinstance(expr, (ast.Tuple, ast.List)):
        out = []
        for e in expr.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
        return tuple(out)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        return (_resolve_tuple(expr.left, env)
                + _resolve_tuple(expr.right, env))
    return ()


def registered_fault_sites(faults_path: Path) -> Set[str]:
    """The closed site registry parsed from ``faults.py`` (the union of
    every ``*_SITES`` module-level tuple)."""
    tree = astutil.load(faults_path).tree
    env: Dict[str, ast.expr] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            env[node.targets[0].id] = node.value
    sites: Set[str] = set()
    for name, value in env.items():
        if name.endswith("_SITES"):
            sites |= set(_resolve_tuple(value, env))
    return sites


def _trip_arg(node: ast.Call) -> Optional[ast.expr]:
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        getattr(f, "id", None)
    if name == "trip" and node.args:
        return node.args[0]
    return None


def check_trip_calls_in_tree(tree: ast.Module, path: Path,
                             sites: Set[str]) -> Tuple[List[Finding],
                                                       Set[str]]:
    """EN02 over one module's ``trip(...)`` calls.

    Returns (findings, covered-sites).  Literal args must be registered;
    f-string args must end in a constant suffix matching a registered
    site's tail (e.g. ``f"SHARDS.{tag}.pre_replace"`` never occurs —
    the sharded sites use fixed names — but ``f"{prefix}.pre_replace"``
    would cover every site ending in ``.pre_replace``).
    """
    findings: List[Finding] = []
    covered: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        arg = _trip_arg(node)
        if arg is None:
            continue
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if arg.value in sites:
                covered.add(arg.value)
            else:
                findings.append(_f(
                    "EN02", path, node.lineno,
                    f"trip({arg.value!r}) names an unregistered fault "
                    "site"))
        elif isinstance(arg, ast.JoinedStr):
            suffix = ""
            if arg.values and isinstance(arg.values[-1], ast.Constant):
                suffix = str(arg.values[-1].value)
            matched = {s for s in sites if suffix and s.endswith(suffix)}
            if matched:
                covered |= matched
            else:
                findings.append(_f(
                    "EN02", path, node.lineno,
                    f"dynamic trip(f\"...{suffix}\") matches no "
                    "registered fault site"))
        else:
            findings.append(_f(
                "EN02", path, node.lineno,
                "trip() argument is not a statically-checkable string"))
    return findings, covered


def check_fault_registry(root: Path) -> List[Finding]:
    """EN02: all trip sites registered AND all registered sites tripped."""
    faults_path = root / "src" / "repro_torch" / "streaming" / "faults.py"
    sites = registered_fault_sites(faults_path)
    findings: List[Finding] = []
    covered: Set[str] = set()
    sdir = root / "src" / "repro_torch" / "streaming"
    for path in sorted(sdir.glob("*.py")):
        if path.name == "faults.py":
            continue
        f, c = check_trip_calls_in_tree(astutil.load(path).tree, path,
                                        sites)
        findings += f
        covered |= c
    for site in sorted(sites - covered):
        findings.append(_f(
            "EN02", faults_path, 1,
            f"registered fault site {site!r} is never tripped by any "
            "streaming write path"))
    return findings


def check_bench_keys(json_path: Path) -> List[Finding]:
    """EN03 over every run summary in a BENCH json file."""
    findings: List[Finding] = []
    if not json_path.exists():
        return findings
    try:
        data = json.loads(json_path.read_text())
    except (ValueError, OSError) as e:
        return [_f("EN03", json_path, 1, f"unreadable bench json: {e}")]
    for i, run in enumerate(data.get("runs", [])):
        for key in run.get("summary", {}):
            if classify_summary_key(key) == "unknown":
                findings.append(_f(
                    "EN03", json_path, 1,
                    f"runs[{i}] ({run.get('bench', '?')}): summary key "
                    f"{key!r} does not follow the gated/parity naming "
                    "convention"))
    return findings
