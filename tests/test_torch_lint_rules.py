"""The port's Python lint rules (``qldpc_fault_tolerance_tpu_torch.analysis``):
R005 event-schema drift, R006 lock discipline, R008 fault-injection sites,
R009 CUDA-graph capture sites, R101 bare print and R102 bare sleep / retry
loops.  Each rule fires on a distilled violation and stays quiet on the
blessed idiom (the JAX package's fixtures, on the port's paths); the port
tree is clean under every rule; and pointed at the JAX package's tree with
its paths, the port's R005, R006, R008, R101 and R102 find exactly what the
JAX package's own rules find there.  The sweep checkpoint's ``truncate``
fault round-trips on the port's ``SweepCheckpoint``.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from qldpc_fault_tolerance_tpu_torch.analysis import (
    AnalysisContext,
    BarePrintRule,
    BareSleepRule,
    CaptureSiteRule,
    FaultSiteRule,
    LockDisciplineRule,
    SchemaDriftRule,
    SourceModule,
    analyze_repo,
    collect_modules,
    default_rules,
    repo_root,
    run_analysis,
)

REPO = repo_root()
PKG = "qldpc_fault_tolerance_tpu_torch/"
FIX = PKG + "sim/_fixture.py"
ALL_RULES = ["R005", "R006", "R007", "R008", "R009", "R101", "R102"]


def run_src(rule, src, rel=FIX, extra=None):
    """Run one rule over snippet modules; returns the AnalysisResult."""
    sources = {rel: src}
    sources.update(extra or {})
    modules = [SourceModule.parse(r, textwrap.dedent(s))
               for r, s in sources.items()]
    return run_analysis(modules, [rule], root=REPO)


def findings_of(rule, src, **kw):
    return [f for f in run_src(rule, src, **kw).findings if f.rule == rule.id]


# ---------------------------------------------------------------------------
# the tree and the command line
# ---------------------------------------------------------------------------
def test_port_tree_is_clean_under_every_rule():
    result = analyze_repo(base=REPO)
    assert result.findings == [], [f.render() for f in result.findings]
    assert result.rules == ALL_RULES and result.files > 50


def test_default_rules_in_id_order():
    assert [r.id for r in default_rules()] == ALL_RULES


def test_command_line_runs_every_rule():
    proc = subprocess.run(
        [sys.executable, "-m", PKG.rstrip("/") + ".analysis", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout)
    assert out["rules"] == ALL_RULES and out["findings"] == []


# ---------------------------------------------------------------------------
# R005 schema drift
# ---------------------------------------------------------------------------
SCHEMA_STUB = """
    EVENT_SCHEMAS = {
        "wer_run": {"required": {"engine": str, "shots": int},
                    "optional": {}},
        "snapshot": {"required": {}, "optional": {}},
    }
    _V1_EVENT_KINDS = frozenset({"wer_run", "snapshot"})
"""
STUB_REL = PKG + "utils/telemetry.py"


def _schema_rule(**floors):
    return SchemaDriftRule(frozen_floors=floors or {"_V1_EVENT_KINDS": 2})


def test_r005_fires_on_unregistered_kind():
    src = """
        from ..utils import telemetry

        def f():
            telemetry.event("not_a_kind", x=1)
    """
    found = findings_of(_schema_rule(), src, extra={STUB_REL: SCHEMA_STUB})
    assert len(found) == 1 and "not_a_kind" in found[0].message


def test_r005_fires_on_missing_required_field():
    src = """
        from ..utils import telemetry

        def f():
            telemetry.event("wer_run", engine="data")
    """
    found = findings_of(_schema_rule(), src, extra={STUB_REL: SCHEMA_STUB})
    assert len(found) == 1 and "'shots'" in found[0].message


def test_r005_fires_when_frozen_set_shrinks():
    shrunk = SCHEMA_STUB.replace('frozenset({"wer_run", "snapshot"})',
                                 'frozenset({"wer_run"})')
    found = findings_of(_schema_rule(), "x = 1", extra={STUB_REL: shrunk})
    assert len(found) == 1 and "shrank" in found[0].message


def test_r005_fires_on_frozen_kind_without_schema():
    grown = SCHEMA_STUB.replace('frozenset({"wer_run", "snapshot"})',
                                'frozenset({"wer_run", "snapshot", "ghost"})')
    found = findings_of(_schema_rule(), "x = 1", extra={STUB_REL: grown})
    assert len(found) == 1 and "'ghost'" in found[0].message


def test_r005_clean_emissions_pass():
    src = """
        from ..utils import telemetry
        from ..utils.observability import get_logger, log_record

        def f(fields):
            telemetry.event("wer_run", engine="data", shots=64)
            telemetry.event("wer_run", **fields)
            log_record(get_logger(), "snapshot")
    """
    assert not findings_of(_schema_rule(), src,
                           extra={STUB_REL: SCHEMA_STUB})


def test_r005_reads_the_port_telemetry_floors():
    """The shipped floors hold against the port's own telemetry module:
    every frozen set is there, at least as large as its floor."""
    rule = SchemaDriftRule()
    (mod,) = collect_modules([os.path.join(REPO, STUB_REL)], REPO)
    assert rule.schema_module_rel == STUB_REL
    assert not list(rule.check(mod, AnalysisContext([mod], root=REPO)))
    assert sorted(rule.frozen_floors) == [f"_V{i}_EVENT_KINDS"
                                          for i in range(1, 8)]


# ---------------------------------------------------------------------------
# R006 lock discipline
# ---------------------------------------------------------------------------
def test_r006_fires_on_unlocked_module_state_write():
    src = """
        import threading

        _REGISTRY = {}
        _EVENTS = []

        def register(name, obj):
            _REGISTRY[name] = obj

        def emit(e):
            _EVENTS.append(e)

        def reset():
            global _REGISTRY
            _REGISTRY = {}
    """
    found = findings_of(LockDisciplineRule(), src,
                        rel=PKG + "utils/_fixture.py")
    assert len(found) == 3


def test_r006_locked_and_threadlocal_writes_pass():
    src = """
        import threading

        _LOCK = threading.Lock()
        _REGISTRY = {}
        _TL = threading.local()
        _SNAPSHOT = ()

        def register(name, obj):
            with _LOCK:
                _REGISTRY[name] = obj

        def set_tl(x):
            _TL.value = x

        def swap(t):
            global _SNAPSHOT
            _SNAPSHOT = tuple(t)
    """
    assert not findings_of(LockDisciplineRule(), src,
                           rel=PKG + "serve/_fixture.py")


def test_r006_only_scopes_serve_and_utils():
    src = """
        _CACHE = {}

        def put(k, v):
            _CACHE[k] = v
    """
    assert not findings_of(LockDisciplineRule(), src,
                           rel=PKG + "codes/_fixture.py")


# the check-then-set forms of the two memos the rule found in the port
UNLOCKED_MEMOS = {
    "utils/device.py": """
        import threading
        _body_streams: dict = {}

        def _body_stream(device, depth):
            key = (device.index, depth)
            stream = _body_streams.get(key)
            if stream is None:
                stream = _body_streams[key] = make(device)
            return stream
    """,
    "utils/telemetry.py": """
        import threading
        _EDGES: dict = {}

        def _iter_edges(device):
            key = str(device)
            edges = _EDGES.get(key)
            if edges is None:
                edges = _EDGES[key] = make(device)
            return edges
    """,
}


@pytest.mark.parametrize("rel", sorted(UNLOCKED_MEMOS))
def test_r006_fires_on_the_unlocked_memo_and_not_on_its_repair(rel):
    src = UNLOCKED_MEMOS[rel]
    (f,) = findings_of(LockDisciplineRule(), src, rel=PKG + rel)
    assert "outside a `with <lock>` block" in f.message
    with open(os.path.join(REPO, PKG + rel), encoding="utf-8") as fh:
        repaired = fh.read()
    assert not findings_of(LockDisciplineRule(), repaired, rel=PKG + rel)


# ---------------------------------------------------------------------------
# R008 faultinject site discipline
# ---------------------------------------------------------------------------
FAULT_MOD = PKG + "utils/faultinject.py"
FAULT_SITES_SRC = """
    SITES = {
        "alpha_site": "module a's failure point",
        "ckpt_site": "checkpoint append",
    }
"""


def run_fault_rule(sources):
    all_sources = {FAULT_MOD: FAULT_SITES_SRC}
    all_sources.update(sources)
    modules = [SourceModule.parse(r, textwrap.dedent(s))
               for r, s in all_sources.items()]
    return run_analysis(modules, [FaultSiteRule()], root=REPO)


def test_r008_fires_on_unregistered_site_literal():
    res = run_fault_rule({FIX: """
        from ..utils import faultinject

        def f():
            faultinject.site("alfa_site")  # typo'd: never in SITES
    """})
    found = [f for f in res.findings if f.rule == "R008"]
    assert any("not registered" in f.message and "alfa_site" in f.message
               for f in found)


def test_r008_fires_on_duplicate_site_across_modules():
    res = run_fault_rule({
        PKG + "sim/_fa.py": """
            from ..utils import faultinject

            def f():
                faultinject.site("alpha_site")
        """,
        PKG + "sim/_fb.py": """
            from ..utils import faultinject

            def g():
                faultinject.site("alpha_site")
                faultinject.truncate_fraction("ckpt_site")
        """,
    })
    found = [f for f in res.findings if f.rule == "R008"]
    assert len(found) == 1
    assert found[0].file == PKG + "sim/_fb.py"
    assert "also planted at" in found[0].message
    assert "sim/_fa.py" in found[0].message


def test_r008_fires_on_stale_sites_table_entry():
    res = run_fault_rule({FIX: """
        from ..utils import faultinject

        def f():
            faultinject.site("alpha_site")
    """})
    found = [f for f in res.findings if f.rule == "R008"]
    assert len(found) == 1
    assert found[0].file == FAULT_MOD
    assert "ckpt_site" in found[0].message and "plant" in found[0].message


def test_r008_quiet_on_registered_unique_and_dynamic_sites():
    res = run_fault_rule({FIX: """
        from ..utils import faultinject

        def f(site_name):
            faultinject.site("alpha_site")
            faultinject.truncate_fraction("ckpt_site")
            faultinject.site(site_name)       # dynamic: out of scope
            faultinject.site("wer." + "x")    # non-literal: out of scope
    """})
    assert [f for f in res.findings if f.rule == "R008"] == []


def test_r008_checkpoint_site_is_planted_in_the_port():
    modules = collect_modules([os.path.join(REPO, PKG)], REPO)
    found = [f for f in run_analysis(modules, [FaultSiteRule()],
                                     root=REPO).findings]
    assert found == []
    with open(os.path.join(REPO, PKG + "utils/checkpoint.py"),
              encoding="utf-8") as fh:
        assert 'faultinject.truncate_fraction("sweep_ckpt_put")' in fh.read()


# ---------------------------------------------------------------------------
# R009 CUDA-graph capture sites
# ---------------------------------------------------------------------------
def test_r009_fires_on_cuda_graph_outside_the_capture_sites():
    found = findings_of(CaptureSiteRule(), """
        import torch

        def replay_fast(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            return g
    """, rel=PKG + "sim/_fixture.py")
    assert len(found) == 2
    assert "_capture_graph" in found[0].message


def test_r009_follows_aliases():
    found = findings_of(CaptureSiteRule(), """
        import torch.cuda as tc
        from torch.cuda import CUDAGraph as G, graph

        def f(fn):
            g = G()
            with graph(g):
                fn()
            return tc.CUDAGraph()
    """, rel=PKG + "serve/_fixture.py")
    assert len(found) == 3


def test_r009_quiet_in_the_blessed_sites():
    src = """
        import torch

        def {name}(fn):
            def body():
                return torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(body()):
                fn()
    """
    for rel, name in CaptureSiteRule.DEFAULT_SITES:
        assert not findings_of(CaptureSiteRule(), src.format(name=name),
                               rel=rel)
    # the same function name in another module is no capture site
    assert len(findings_of(CaptureSiteRule(),
                           src.format(name="_capture_graph"),
                           rel=PKG + "utils/device.py")) == 2


def test_r009_ignores_other_graph_calls():
    assert not findings_of(CaptureSiteRule(), """
        import networkx

        def f(h):
            return networkx.graph(h), h.graph(), graph_nodes(h)
    """)


# ---------------------------------------------------------------------------
# R101 / R102
# ---------------------------------------------------------------------------
def test_r101_fires_on_bare_print():
    found = findings_of(BarePrintRule(), "def f():\n    print('x')\n")
    assert len(found) == 1


@pytest.mark.parametrize("rel", ["utils/par2gen.py", "compat/par2gen.py",
                                 "analysis/__main__.py"])
def test_r101_exemptions_and_docstrings(rel):
    rule = BarePrintRule()
    assert not findings_of(rule, "def f():\n    print('x')\n", rel=PKG + rel)
    assert not findings_of(rule, 'def f():\n    """print(x)"""\n')


def test_r102_fires_on_sleep_and_retry_loop():
    src = """
        import time

        def f():
            for attempt in range(3):
                time.sleep(0.1)
    """
    assert len(findings_of(BareSleepRule(), src)) == 2


def test_r102_catches_aliased_and_from_import_sleep():
    src = """
        import time as t
        from time import sleep

        def f():
            sleep(1.0)
            t.sleep(2.0)
    """
    found = findings_of(BareSleepRule(), src)
    assert len(found) == 2 and "time.sleep" in found[0].message


def test_r102_exempts_resilience_and_plain_loops():
    rule = BareSleepRule()
    src = "import time\n\ndef f():\n    time.sleep(1)\n"
    assert not findings_of(rule, src, rel=PKG + "utils/resilience.py")
    assert not findings_of(rule, "def f():\n    for i in range(3):\n"
                                 "        pass\n")


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------
def test_suppression_on_same_line_and_line_above():
    src = """
        def f():
            print('a')  # qldpc: ignore[R101]
            # qldpc: ignore[R101]
            print('b')
    """
    res = run_src(BarePrintRule(), src)
    assert not res.findings and res.suppressed == 2


def test_unused_suppression_is_a_finding():
    res = run_src(BarePrintRule(), "def f():\n    return 1  "
                                   "# qldpc: ignore[R101]\n")
    assert len(res.findings) == 1 and res.findings[0].rule == "R000"


def test_suppression_only_masks_listed_rules():
    res = run_src(BarePrintRule(), """
        def f():
            print('x')  # qldpc: ignore[R102]
    """)
    assert {f.rule for f in res.findings} == {"R101"}


# ---------------------------------------------------------------------------
# cross-check: the port's rules on the JAX package's tree == the JAX rules
# ---------------------------------------------------------------------------
JPKG = "qldpc_fault_tolerance_tpu/"


def _port_rules_on_jax_tree():
    from qldpc_fault_tolerance_tpu_torch.analysis import rules_runtime, \
        rules_style

    return {
        "R005": rules_runtime.SchemaDriftRule(
            schema_module_rel=JPKG + "utils/telemetry.py"),
        "R006": rules_runtime.LockDisciplineRule(
            scopes=(JPKG + "serve/", JPKG + "utils/")),
        "R008": rules_runtime.FaultSiteRule(
            site_module_rel=JPKG + "utils/faultinject.py"),
        "R101": rules_style.BarePrintRule(
            exempt=(JPKG + "utils/par2gen.py", JPKG + "compat/par2gen.py",
                    JPKG + "analysis/__main__.py"), package_prefix=JPKG),
        "R102": rules_style.BareSleepRule(
            exempt=(JPKG + "utils/resilience.py",),
            scripts=("scripts/parity.py",), package_prefix=JPKG),
    }


def _raw(rule, modules, ctx):
    """(file, line, rule) of every finding, before suppressions and
    baseline."""
    return {(f.file, f.line, f.rule) for m in modules if rule.applies(m.rel)
            for f in rule.check(m, ctx)}


@pytest.fixture(scope="module")
def jax_tree():
    from qldpc_fault_tolerance_tpu import analysis as janalysis

    jmods = janalysis.collect_modules(None, base=REPO)
    tmods = collect_modules([os.path.join(REPO, JPKG),
                             os.path.join(REPO, "scripts")], REPO)
    jrules = {r.id: r for r in janalysis.default_rules()}
    return (jmods, janalysis.AnalysisContext(jmods), jrules,
            tmods, AnalysisContext(tmods, root=REPO))


@pytest.mark.parametrize("rule_id", ["R005", "R006", "R008", "R101", "R102"])
def test_port_rules_equal_jax_rules_on_the_jax_tree(jax_tree, rule_id):
    jmods, jctx, jrules, tmods, tctx = jax_tree
    assert [m.rel for m in jmods] == [m.rel for m in tmods]
    want = _raw(jrules[rule_id], jmods, jctx)
    got = _raw(_port_rules_on_jax_tree()[rule_id], tmods, tctx)
    assert got == want


# ---------------------------------------------------------------------------
# the checkpoint's truncate fault (the site R008 found unplanted)
# ---------------------------------------------------------------------------
def test_checkpoint_write_kill_injection_roundtrip(tmp_path):
    from qldpc_fault_tolerance_tpu_torch.utils import faultinject
    from qldpc_fault_tolerance_tpu_torch.utils.checkpoint import \
        SweepCheckpoint

    path = str(tmp_path / "sweep.jsonl")
    ckpt = SweepCheckpoint(path)
    ckpt.put({"p": 0.01}, {"wer": 0.5})
    plan = faultinject.FaultPlan([
        faultinject.Fault(site="sweep_ckpt_put", kind="truncate"),
    ])
    with plan.active():
        with pytest.raises(faultinject.InjectedFault):
            ckpt.put({"p": 0.02}, {"wer": 0.25})
    # the surviving process appends again: the torn tail must not corrupt
    # the next record (the writer starts it on a fresh line)
    ckpt.put({"p": 0.03}, {"wer": 0.125})
    with pytest.warns(UserWarning, match="corrupt checkpoint line"):
        ckpt2 = SweepCheckpoint(path)
    assert len(ckpt2) == 2
    assert ckpt2.get({"p": 0.01}) == {"wer": 0.5}
    assert ckpt2.get({"p": 0.03}) == {"wer": 0.125}
    assert ckpt2.get({"p": 0.02}) is None  # the killed append is lost
