"""The port's static analysis (repro_torch.analysis): corpus, clean port,
parity with repro.analysis, and mutations of the real port.

Two-sided, as ``tests/test_analysis.py`` holds the JAX package's pass:
every seeded-violation case under ``tests/analysis_corpus_torch/`` is
flagged with exactly its rule ids (the analyzer finds what it claims),
and the port lints clean (the contracts describe the code as it is).
The OR and EN rules are the JAX package's, restated over the port's
files: on the same inputs both packages give the same findings.  The
KC rules read the CUDA sources as text, so each mutation of the real
port is made on a copy of ``kernels/`` under ``tmp_path`` and must be
flagged by its rule.  Nothing here compiles or runs a kernel: the
compiled half (``resources``) is held on canned ptxas text.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
import shutil
from pathlib import Path

import pytest

from repro.analysis import astutil as jastutil
from repro.analysis import engine_rules as jengine
from repro.analysis import oracle_rules as joracle
from repro.analysis.bench_schema import classify_summary_key as jclassify
from repro_torch.analysis import astutil, corpus, cuda_src, engine_rules, \
    kernel_rules, linter, oracle_rules, resources
from repro_torch.analysis.bench_schema import classify_summary_key
from repro_torch.analysis.contracts import KERNEL_MODULES, REGISTRY
from repro_torch.analysis.report import RULES, Finding, Report
from repro_torch.kernels import flash_attention, knn_topk, serving_topn
from repro_torch.launch import mesh

ROOT = Path(__file__).resolve().parents[1]
CORPUS_DIR = ROOT / "tests" / "analysis_corpus_torch"
MANIFEST = json.loads((CORPUS_DIR / "manifest.json").read_text())
JAX_CORPUS = ROOT / "tests" / "analysis_corpus"
KDIR = ROOT / "src" / "repro_torch" / "kernels"
CSRC = KDIR / "csrc"
OPTIN = mesh.SMEM_PER_BLOCK_OPTIN

linter.load_contracts()


# ------------------------------------------------------------ the corpus
@pytest.mark.parametrize("case", sorted(MANIFEST))
def test_corpus_case_flagged_exactly(case):
    result = corpus.run_case(CORPUS_DIR / case, MANIFEST[case])
    assert result.ok, str(result)


def test_corpus_rules_are_known():
    for case, spec in MANIFEST.items():
        for rule in spec["rules"]:
            assert rule in RULES, (case, rule)


def test_corpus_covers_every_family():
    seeded = {r for spec in MANIFEST.values() for r in spec["rules"]}
    assert {"KC01", "KC02", "KC03", "KC04", "KC05", "KC06", "KC07",
            "KC08", "OR01", "OR03", "EN01", "EN02", "EN03"} <= seeded
    en01 = [c for c, s in MANIFEST.items() if s["rules"] == ["EN01"]]
    assert len(en01) >= 2                 # a direct and a thread bypass
    for case in MANIFEST:
        if case.endswith(".py"):
            first = (CORPUS_DIR / case).read_text().splitlines()[0]
            assert first == "# ruff: noqa", case
        assert case.endswith((".cu", ".py", ".json")), case


# ------------------------------------------------------------ the port
def test_port_lints_clean():
    report = linter.lint_repo(ROOT)
    assert report.ok, "\n".join(str(f) for f in report.findings)
    assert {m for m, _ in REGISTRY} == set(KERNEL_MODULES)
    assert len(REGISTRY) == 11


def test_contracts_name_every_global():
    sources = cuda_src.load_dir(CSRC)
    defined = {g.name for s in sources.values() for g in s.globals()}
    named = {k for c in REGISTRY.values() for k in c.kernels}
    assert len(defined) == 23 and named == defined
    build = kernel_rules.read_build(KDIR / "build.py")
    assert {c.entry for c in REGISTRY.values()} == set(build.signatures)
    # every prototype's arity is its argtypes' (KC02 holds element-wise)
    for c in REGISTRY.values():
        proto = {p.name: p for p in sources[c.source].prototypes()}[c.entry]
        assert len(proto.params) == len(build.signatures[c.entry]), c.entry


def test_every_contract_fits_a_block():
    for c in REGISTRY.values():
        dyn = c.max_smem_bytes()
        for k in c.kernels:
            assert dyn[k] + c.static_smem.get(k, 0) <= OPTIN, (c.entry, k)


def test_lexer_reads_launches_and_grids():
    src = cuda_src.CudaSource(CSRC / "knn_topk_dtiled.cu")
    kernels = set(kernel_rules.visible_kernels(
        src, cuda_src.load_dir(CSRC)))
    launches = {x.line: x for x in src.launches(kernels)}
    kinds = {x.kernels[0]: kernel_rules.grid_kind(x.grid_expanded)
             for x in launches.values()}
    # the first pass's grid arrives through three helpers' parameters
    assert kinds["dtiled_mma_kernel"] == "cdiv"
    assert kinds["dtiled_finish_kernel"] == "cdiv"
    assert kinds["merge_lists_kernel"] == "exact"
    wg = cuda_src.CudaSource(CSRC / "flash_attention_wgmma.cu")
    (x,) = wg.launches({"flash_wgmma_kernel"})
    assert kernel_rules.grid_kind(x.grid_expanded) == "persistent"
    # a helper that forwards its parameter raises each kernel's limit
    bwd = cuda_src.CudaSource(CSRC / "flash_attention_bwd.cu")
    raised = {k for a in bwd.smem_attributes(set(
        flash_attention.BWD_KERNELS["cuda_cores"])) for k in a.kernels}
    assert raised == set(flash_attention.BWD_KERNELS["cuda_cores"])
    # comments and strings are blanked; asm text is kept for KC05/KC07
    hopper = cuda_src.CudaSource(CSRC / "flash_hopper.cuh")
    assert {m.accumulate for m in hopper.mmas} == {"f32"}
    assert "ex2.approx" in hopper.code and "ex2.approx" not in hopper.bare


def test_report_json_shape():
    f = Finding(rule="KC01", path="a.cu", line=3, message="m")
    report = Report(findings=[f])
    doc = json.loads(report.to_json())
    assert doc["ok"] is False
    assert doc["counts"] == {"KC01": 1}
    assert doc["findings"][0]["description"] == RULES["KC01"]
    assert str(f) == "a.cu:3: KC01 m"
    assert Report().ok


def test_uses_kernel_is_a_helper_not_a_dispatcher():
    tree = astutil.load(KDIR / "ops.py").tree
    dispatchers = oracle_rules.public_dispatchers(tree)
    assert "uses_kernel" not in dispatchers
    assert "default_impl" not in dispatchers
    assert {"knn_topk", "flash_attention"} <= set(dispatchers)


# ------------------------------------------------- one shared-memory size
def test_one_copy_of_the_shared_memory_sizes():
    assert (mesh.SMEM_PER_BLOCK_OPTIN, mesh.SMEM_PER_SM) == (232448, 233472)
    assert knn_topk.SMEM_MAX is mesh.SMEM_PER_BLOCK_OPTIN
    assert flash_attention.SMEM_MAX is mesh.SMEM_PER_BLOCK_OPTIN
    assert serving_topn.SM_SHARED_BYTES is mesh.SMEM_PER_SM
    pattern = re.compile(r"\b(232_?448|233_?472)\b")
    holders = [p.relative_to(ROOT).as_posix()
               for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
               if pattern.search(p.read_text())]
    assert holders == ["src/repro_torch/launch/mesh.py"], holders
    # the C constants KC03 holds to it
    consts = [v for s in cuda_src.load_dir(CSRC).values()
              for v, _ in s.smem_max]
    assert consts == [OPTIN, OPTIN]


def _constexprs(*names):
    env = {}
    for name in names:
        text = cuda_src.CudaSource(CSRC / name).bare
        for m in re.finditer(r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*"
                             r"([^;]+);", text):
            expr = re.sub(r"\b[A-Za-z_]\w*\b",
                          lambda w: str(env.get(w.group(0), w.group(0))),
                          m.group(2)).replace("/", "//")
            try:
                env[m.group(1)] = int(eval(expr, {}))
            except (NameError, SyntaxError, TypeError):
                pass
    return env


def test_int8_plan_bytes_match_the_c_formulas():
    c = _constexprs("knn_ring.cuh", "topk_common.cuh", "knn_topk_dtiled.cu")
    for n2 in (0, 64, 512, 1024):
        assert knn_topk.tile_smem_bytes(n2) == (
            4 * c["STAGE_WORDS"] + 8 * (c["CC_BQ"] * n2 + c["NWARP"]
                                        * c["MERGE_CAND"]) + 4 * c["CC_BM"])
        assert knn_topk.finish_smem_bytes(n2) == (
            4 * (c["FIN_BQ"] * c["FIN_BM"] + c["FIN_BM"])
            + 8 * (c["FIN_BQ"] * n2 + c["NWARP"] * c["MERGE_CAND"]))
    for bq, stages, ls in ((32, 3, 300), (16, 2, 1024), (32, 5, 0)):
        assert knn_topk.tc_smem_bytes(bq, stages, ls) == (
            stages * (c["TC_BM"] + bq) * c["TC_PITCH"]
            + 8 * (bq * ls + c["TC_NWARP"] * c["MERGE_CAND"])
            + 4 * c["TC_BM"])
    assert knn_topk.tc_stages(32, 300, False) == 3
    assert knn_topk.tc_stages(16, 1024, False) == 2


# ------------------------------------------- parity with repro.analysis
def _rlm(findings):
    return [(f.rule, f.line, f.message) for f in findings]


def test_bench_key_classifier_matches_jax():
    keys = ("speedup_vs_ref", "pallas_compiled", "p50_ms", "qps_mean",
            "shards", "frobnication_index", "slo_p99_fraction",
            "drift_max", "certified")
    for key in keys:
        assert classify_summary_key(key) == jclassify(key), key
    assert classify_summary_key("frobnication_index") == "unknown"


def test_cdiv_normalization_matches_jax():
    spellings = ("def f(d, bd):\n    nt = pl.cdiv(d, bd)\n    return nt\n",
                 "def f(d, bd):\n    nt = -(-d // bd)\n    return nt\n",
                 "def f(d, bd):\n    nt = d // bd\n    return nt\n")
    ours = [astutil.normalized_body_dump(ast.parse(s).body[0])
            for s in spellings]
    theirs = [jastutil.normalized_body_dump(ast.parse(s).body[0])
              for s in spellings]
    assert ours == theirs
    assert ours[0] == ours[1] != ours[2]


_EN_INPUTS = sorted(JAX_CORPUS.glob("en01_*.py")) + \
    [JAX_CORPUS / "en02_unknown_site.py"] + \
    sorted((ROOT / "src" / "repro" / "streaming").glob("*.py"))


@pytest.mark.parametrize("path", _EN_INPUTS, ids=lambda p: p.name)
def test_engine_rules_match_jax(path):
    tree = astutil.load(path).tree
    assert _rlm(engine_rules.check_commit_paths_in_tree(tree, path)) == \
        _rlm(jengine.check_commit_paths_in_tree(tree, path))
    faults = ROOT / "src" / "repro" / "streaming" / "faults.py"
    sites = engine_rules.registered_fault_sites(faults)
    assert sites == jengine.registered_fault_sites(faults)
    ours, ours_cov = engine_rules.check_trip_calls_in_tree(tree, path, sites)
    theirs, theirs_cov = jengine.check_trip_calls_in_tree(tree, path, sites)
    assert (_rlm(ours), ours_cov) == (_rlm(theirs), theirs_cov)


def test_oracle_rules_match_jax():
    path = JAX_CORPUS / "or01_missing_oracle.py"
    tree = astutil.load(path).tree
    ours = oracle_rules.check_dispatchers_in_tree(tree, path, set())
    assert _rlm(ours) == _rlm(joracle.check_dispatchers_in_tree(
        tree, path, set()))
    assert [f.rule for f in ours] == ["OR01"]
    dup = JAX_CORPUS / "or03_drifted_duplicate.py"
    pair = ((dup, "tiled_thing"), (dup, "tiled_thing_ref"))
    ours = oracle_rules.check_duplicate_pair(*pair)
    assert _rlm(ours) == _rlm(joracle.check_duplicate_pair(*pair))
    assert [f.rule for f in ours] == ["OR03"]


def test_en_rules_hold_on_the_port():
    assert engine_rules.check_commit_paths(ROOT) == []
    assert engine_rules.check_fault_registry(ROOT) == []
    assert not (ROOT / "BENCH_torch.json").exists()


# ------------------------------------------ mutations of the real port
@pytest.fixture
def port_copy(tmp_path):
    dst = tmp_path / "src" / "repro_torch" / "kernels"
    shutil.copytree(CSRC, dst / "csrc")
    shutil.copy(KDIR / "build.py", dst / "build.py")
    return tmp_path


def _kc(root, registry=None):
    return [f.rule for f in kernel_rules.check_kernels(
        root, REGISTRY if registry is None else registry, OPTIN)]


def _edit(path, old, new, count=1):
    text = path.read_text()
    assert old in text, (path, old)
    path.write_text(text.replace(old, new, count))


def test_copy_of_the_port_lints_clean(port_copy):
    assert _kc(port_copy) == []


def test_mutation_flipped_argtype(port_copy):
    build = port_copy / "src/repro_torch/kernels/build.py"
    _edit(build, '"decayed_scatter_launch": [_P, _P, _P, _I,',
          '"decayed_scatter_launch": [_P, _P, _P, _L,')
    assert set(_kc(port_copy)) == {"KC02"}


def test_mutation_f16_accumulate_in_flash_hopper(port_copy):
    _edit(port_copy / "src/repro_torch/kernels/csrc/flash_hopper.cuh",
          ".f32.bf16.bf16", ".f16.bf16.bf16")
    assert set(_kc(port_copy)) == {"KC05"}


def test_mutation_expf_in_knn_topk(port_copy):
    _edit(port_copy / "src/repro_torch/kernels/csrc/knn_topk.cu",
          "  if (err != cudaSuccess) return err;\n",
          "  if (err != cudaSuccess) return err;\n  (void)__expf(1.0f);\n")
    assert set(_kc(port_copy)) == {"KC07"}


def test_mutation_flash_header_in_exact_source(port_copy):
    _edit(port_copy / "src/repro_torch/kernels/csrc/serving_topn.cu",
          '#include "topk_common.cuh"\n',
          '#include "topk_common.cuh"\n#include "flash_hopper.cuh"\n')
    rules = _kc(port_copy)
    assert "KC07" in rules
    # its wgmma strings are also no accumulate the contract declares
    assert set(rules) == {"KC05", "KC07"}


def test_mutation_max_shapes_past_a_block(port_copy):
    key = ("repro_torch.kernels.flash_attention", "flash_wgmma_launch")
    registry = dict(REGISTRY)
    registry[key] = dataclasses.replace(registry[key],
                                        max_shapes={"d": 192, "dv": 192})
    assert flash_attention.wgmma_smem_bytes(192, 2, 192) > OPTIN
    assert set(_kc(port_copy, registry)) == {"KC03"}


def test_mutation_global_without_contract(port_copy):
    _edit(port_copy / "src/repro_torch/kernels/csrc/decayed_scatter.cu",
          "}  // namespace\n",
          "__global__ void stray_kernel(float* out) { out[0] = 0.f; }\n\n"
          "}  // namespace\n")
    assert set(_kc(port_copy)) == {"KC01"}


def test_mutation_fast_math_flag(port_copy):
    _edit(port_copy / "src/repro_torch/kernels/build.py",
          '"-O3", ', '"-O3", "--use_fast_math", ')
    assert set(_kc(port_copy)) == {"KC07"}


def test_mutation_tail_guard_removed(port_copy):
    _edit(port_copy / "src/repro_torch/kernels/csrc/sparse_row_gather.cu",
          "  if (e >= n) return;\n", "")
    assert set(_kc(port_copy)) == {"KC04"}


def test_mutation_smem_attribute_dropped(port_copy):
    _edit(port_copy / "src/repro_torch/kernels/csrc/serving_rows.cu",
          "cudaFuncAttributeMaxDynamicSharedMemorySize",
          "cudaFuncAttributePreferredSharedMemoryCarveout")
    # serving_rows' 33,088 bytes stay under 48 KiB: nothing to raise
    assert _kc(port_copy) == []
    _edit(port_copy / "src/repro_torch/kernels/csrc/knn_topk.cu",
          "cudaFuncAttributeMaxDynamicSharedMemorySize",
          "cudaFuncAttributePreferredSharedMemoryCarveout")
    assert set(_kc(port_copy)) == {"KC03"}


# ------------------------------------------------ the compiled half
_CLEAN_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124sparse_row_gather_kernelIiiEEvPKfPKT_PKT0_Pfiixi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124sparse_row_gather_kernelIiiEEvPKfPKT_PKT0_Pfiixi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 0 barriers, 404 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112scatter_rowsEPfPKiPKfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112scatter_rowsEPfPKiPKfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 32772 bytes smem, 388 bytes cmem[0]
ptxas info    : Compiling entry function '_ZL18merge_lists_kernelPKfPKiiiiiPfPi' for 'sm_90a'
ptxas info    : Function properties for _ZL18merge_lists_kernelPKfPKiiiiiPfPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 1 barriers, 396 bytes cmem[0]
"""


def _subset(*entries):
    keep = set(entries)
    return [c for c in REGISTRY.values() if c.entry in keep]


def test_ptxas_log_parsed():
    recs = resources.parse_ptxas(_CLEAN_LOG)
    assert [r.kernel for r in recs] == ["sparse_row_gather_kernel",
                                        "scatter_rows", "merge_lists_kernel"]
    assert [r.registers for r in recs] == [16, 30, 24]
    assert [r.smem for r in recs] == [0, 32772, 0]
    assert all(r.spill == 0 and r.stack == 0 for r in recs)
    assert resources.kernel_name("plain_name") == "plain_name"


def test_check_compiled_counts_and_spills():
    recs = resources.parse_ptxas(_CLEAN_LOG)
    one = [dataclasses.replace(c, instantiations={k: 1 for k in c.kernels})
           for c in _subset("srg_launch", "decayed_scatter_launch",
                            "knn_topk_launch")]
    one = [dataclasses.replace(c, kernels=tuple(
        k for k in c.kernels if k in {"sparse_row_gather_kernel",
                                      "scatter_rows", "merge_lists_kernel"}))
           for c in one]
    assert resources.check_compiled(one, recs, OPTIN) == []
    # the real contracts want 4 gathers and a zeroing kernel: KC01
    full = _subset("srg_launch", "decayed_scatter_launch")
    rules = {f.rule for f in resources.check_compiled(full, recs, OPTIN)}
    assert rules == {"KC01"}
    spilled = _CLEAN_LOG.replace(
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 30",
        "8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 30")
    recs = resources.parse_ptxas(spilled)
    assert [r.spill for r in recs] == [0, 8, 0]
    found = resources.check_compiled(one, recs, OPTIN)
    assert [f.rule for f in found] == ["KC03"] and "spills" in \
        found[0].message
    # a smaller opt-in than the contracts' models: KC03 per instance
    found = resources.check_compiled(one, resources.parse_ptxas(_CLEAN_LOG),
                                     32768)
    assert {f.rule for f in found} == {"KC03"}
