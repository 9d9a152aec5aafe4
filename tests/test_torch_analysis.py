"""Tier-1 pins for the port's static-analysis gate
(``python -m repro_torch.analysis``), and the gate held to the JAX
package's on the CPU.

* every snippet of ``tests/lint_corpus_torch/`` fires exactly its named
  rule, in the API and through the CLI, and the corpus covers every rule;
* the port's tree is clean: zero findings under its allowlist, no stale
  entry, no rule error, every rule executed, and the CLI gate exits 0;
* the lane checker passes the engine's real trip (flat, with arrivals,
  segmented) and fails mutated copies: an ungated write, a boundary write
  to an event-only buffer, a constant overwrite;
* allowlist suppression, staleness and a missing reason; the CLI's
  ``--require`` of an unknown name and of a vacuous family fail;
* the port's CC rules give the JAX package's findings on both serving
  directories and the JAX corpus, and the port's ``_static_of`` equals
  JAX's for TD003's spec pair;
* the recorder's dataflow, the HD rules' dataflow and exemptions, and the
  runtime guards' bookkeeping on small cases.
"""
import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import (concurrency_rules, driver, graph_tools,
                                  host_rules, lane_rules, runtime,
                                  trace_rules)
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.allowlist import (AllowEntry, apply_allowlist,
                                            load_allowlist)
from repro_torch.analysis.findings import Finding
from repro_torch.sim import jaxsim

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = REPO / "tests" / "lint_corpus_torch"
ALLOWLIST = REPO / "src" / "repro_torch" / "analysis" / "allowlist.toml"
FAMILIES = ("trace-discipline", "host-dispatch", "lane-mask", "concurrency")

# snippet -> the one rule it exists to trip
CORPUS_EXPECT = {
    "bad_td001.py": "TD001",
    "bad_td002.py": "TD002",
    "bad_td003.py": "TD003",
    "bad_td003_scalar.py": "TD003",
    "bad_td004.py": "TD004",
    "bad_hd001.py": "HD001",
    "bad_hd002.py": "HD002",
    "bad_hd002_grad.py": "HD002",
    "bad_hd003.py": "HD003",
    "bad_hd004.py": "HD004",
    "bad_lm001.py": "LM001",
    "bad_lm002.py": "LM002",
    "bad_cc001.py": "CC001",
    "bad_cc002.py": "CC002",
    "bad_cc003.py": "CC003",
}


@pytest.mark.parametrize("fname,rule", sorted(CORPUS_EXPECT.items()))
def test_corpus_snippet_fires(fname, rule):
    rep = driver.run_lint([str(CORPUS / fname)])
    assert not rep.rule_errors, rep.rule_errors
    fired = {f.rule for f in rep.findings}
    assert fired == {rule}, (fired, [f.render() for f in rep.findings])


@pytest.mark.parametrize("fname", sorted(CORPUS_EXPECT))
def test_cli_corpus_snippet_exits_nonzero(fname, capsys):
    assert cli_main([str(CORPUS / fname), "--allowlist", "none",
                     "--fail-on", "warn"]) == 1
    assert CORPUS_EXPECT[fname] in capsys.readouterr().out


def test_corpus_covers_every_rule():
    assert set(CORPUS_EXPECT.values()) == \
        {r.id for r in driver.all_rules()}
    assert sorted(p.name for p in CORPUS.glob("bad_*.py")) == \
        sorted(CORPUS_EXPECT)


@pytest.fixture(scope="module")
def tree_report():
    entries = load_allowlist(str(ALLOWLIST))
    return driver.run_lint(allowlist=entries), entries


def test_clean_tree_zero_findings(tree_report):
    """The port passes its own gate: no findings beyond the allowlist, no
    stale entry, no crashed rule, all thirteen rules executed."""
    rep, entries = tree_report
    assert not rep.rule_errors, rep.rule_errors
    assert rep.findings == [], [f.render() for f in rep.findings]
    assert rep.stale_allowlist == [], \
        [f.render() for f in rep.stale_allowlist]
    assert set(rep.executed) == {r.id for r in driver.all_rules()}
    assert all(e.hits > 0 for e in entries)


def test_tree_scan_covers_the_port_not_the_smoke(tree_report):
    rep, _ = tree_report
    ctx = driver.build_context()
    rels = {rel for _, rel in ctx.files}
    assert "src/repro_torch/sim/jaxsim.py" in rels
    assert not any(r.startswith("src/repro_torch/analysis/") for r in rels)
    assert "chip_smoke.py" not in rels
    assert all(r.startswith("src/repro_torch/") for r in rels)
    # the deliberate float64 sites the allowlist names are live findings
    td001 = {(f.path, f.symbol) for f in rep.suppressed if f.rule == "TD001"}
    assert ("src/repro_torch/sim/jaxsim.py", "_fma32") in td001
    assert ("src/repro_torch/core/multitascpp.py", "update") in td001
    assert ("src/repro_torch/sim/jaxsim.py", "_DeviceEngine._pack") in td001


def test_cli_gate_passes_on_the_tree():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--fail-on", "warn"]
        + [a for fam in FAMILIES for a in ("--require", fam)],
        capture_output=True, text=True, cwd=str(REPO), timeout=600,
        env={**__import__("os").environ, "PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stderr


# ---------------------------------------------------------------------------
# the lane checker against the engine's real trip
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def real_lane_entry():
    return lane_rules.engine_lane_entry("lane-stepper", 3, 6)


@pytest.mark.parametrize("kind", ["flat", "arrive", "seg"])
def test_lane_checker_passes_real_trip(kind):
    n = jaxsim.SEG_AUTO_MIN if kind == "seg" else 3
    entry = lane_rules.engine_lane_entry(kind, n, 6, arrive=kind == "arrive")
    assert ("seg_min" in entry.st0) == (kind == "seg")
    findings = lane_rules.check_lane_entry(entry)
    assert findings == [], [f.render() for f in findings]


def test_lane_checker_sees_the_boundary_write_its_fields(real_lane_entry):
    """The boundary reaches the fields it writes (not vacuously none)."""
    rec, leaves = lane_rules.record_body(real_lane_entry)
    made = [n for op in rec.ops if any(q.endswith("_boundary")
                                       for q in op.stack) for n in op.made]
    tainted = rec.forward_taint(made)
    reached = {graph_tools.top_level_key(p) for p, _, node in leaves
               if node in tainted}
    assert {"thresh", "w", "active", "traces"} <= reached
    assert reached <= set(jaxsim.BOUNDARY_FIELDS) | {"traces"}


def test_lane_checker_fails_ungated_write(real_lane_entry):
    body = real_lane_entry.body

    def mutated(st):
        out = dict(body(st))
        out["t"] = st["frontier"]      # ungated: bypasses the predicate
        return out

    bad = dataclasses.replace(real_lane_entry, body=mutated)
    findings = lane_rules.check_lane_entry(bad)
    assert [(f.rule, f.symbol) for f in findings] == [("LM001", "['t']")], \
        [f.render() for f in findings]


def test_lane_checker_fails_boundary_write_to_event_field(monkeypatch):
    orig = jaxsim._Engine._boundary

    def _boundary(self, go):
        orig(self, go)
        self.st["cursor"].add_(go[:, None])   # an event-only buffer

    monkeypatch.setattr(jaxsim._Engine, "_boundary", _boundary)
    entry = lane_rules.engine_lane_entry("boundary-overreach", 3, 6)
    findings = lane_rules.check_lane_entry(entry)
    assert [(f.rule, f.symbol) for f in findings] == \
        [("LM002", "['cursor']")], [f.render() for f in findings]


def test_lane_checker_fails_a_boundary_that_writes_nothing(monkeypatch):
    monkeypatch.setattr(jaxsim._Engine, "_boundary",
                        lambda self, go: None)
    entry = lane_rules.engine_lane_entry("no-boundary", 3, 6)
    findings = lane_rules.check_lane_entry(entry)
    assert ("LM002", "boundary") in {(f.rule, f.symbol) for f in findings}


def test_lane_checker_rejects_constant_overwrite(real_lane_entry):
    body = real_lane_entry.body

    def mutated(st):
        out = dict(body(st))
        out["last_done_t"] = torch.zeros_like(st["last_done_t"])
        return out

    bad = dataclasses.replace(real_lane_entry, body=mutated)
    findings = lane_rules.check_lane_entry(bad)
    assert [(f.rule, f.symbol) for f in findings] == \
        [("LM001", "['last_done_t']")], [f.render() for f in findings]
    assert "constant" in findings[0].message


# ---------------------------------------------------------------------------
# allowlist + CLI fail-closed semantics
# ---------------------------------------------------------------------------
def test_allowlist_suppression_and_staleness():
    hit = AllowEntry("HD003", "tests/lint_corpus_torch/bad_hd003.py",
                     "make_graph", "corpus pin")
    stale = AllowEntry("HD001", "no/such/file.py", None, "obsolete")
    rep = driver.run_lint([str(CORPUS / "bad_hd003.py")],
                          allowlist=[hit, stale])
    assert rep.findings == []            # the real finding is suppressed
    assert len(rep.suppressed) == 1 and hit.hits == 1
    assert len(rep.stale_allowlist) == 1  # the dead entry is an error
    assert "obsolete" in rep.stale_allowlist[0].message


def test_allowlist_missing_reason_fails(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text('[[allow]]\nrule = "HD002"\n'
                 'path = "src/repro_torch/serving/client.py"\n')
    with pytest.raises(ValueError, match="reason"):
        load_allowlist(str(p))


def test_shipped_allowlist_is_exact_and_explained():
    entries = load_allowlist(str(ALLOWLIST))
    assert entries and all(e.reason.strip() for e in entries)
    keys = [(e.rule, e.path, e.symbol) for e in entries]
    assert len(keys) == len(set(keys))


def _run_cli(*argv):
    env = {**__import__("os").environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        capture_output=True, text=True, cwd=str(REPO), env=env, timeout=300)


def test_cli_require_unknown_name_fails():
    r = _run_cli(str(CORPUS / "bad_cc001.py"), "--allowlist", "none",
                 "--require", "definitely-missing-rule")
    assert r.returncode != 0, r.stdout + r.stderr
    assert "definitely-missing-rule" in r.stdout + r.stderr


def test_cli_require_vacuous_family_fails():
    """HD001's warn finding alone does not fail at --fail-on error; the
    required trace family has no entries in the file, so the run fails
    as vacuous."""
    r = _run_cli(str(CORPUS / "bad_hd001.py"), "--allowlist", "none",
                 "--fail-on", "error", "--require", "trace-discipline")
    assert r.returncode != 0, r.stdout + r.stderr
    assert "did not execute" in r.stderr


def test_cli_lists_every_rule(capsys):
    assert cli_main(["--list"]) == 0
    out = capsys.readouterr().out
    assert all(r.id in out for r in driver.all_rules())


# ---------------------------------------------------------------------------
# held to the JAX package
# ---------------------------------------------------------------------------
_CC_FILES = sorted(
    [p.relative_to(REPO) for p in (REPO / "src" / "repro" / "serving")
     .glob("*.py")]
    + [p.relative_to(REPO) for p in (REPO / "src" / "repro_torch"
                                     / "serving").glob("*.py")]
    + [p.relative_to(REPO) for p in (REPO / "tests" / "lint_corpus")
       .glob("bad_cc00*.py")])


@pytest.mark.parametrize("rel", _CC_FILES, ids=str)
def test_cc_rules_equal_the_jax_packages(rel):
    from repro.analysis import concurrency_rules as jax_cc
    src = (REPO / rel).read_text()
    ours = concurrency_rules.scan_source(str(rel), src)
    theirs = jax_cc.scan_source(str(rel), src)
    assert [dataclasses.astuple(f) for f in ours] == \
        [dataclasses.astuple(f) for f in theirs]
    if "lint_corpus" in str(rel):
        assert ours, "each JAX corpus snippet fires"


def test_transport_lock_map_has_no_stale_entry():
    """The port's _Channel map lists only _tokens, as the JAX package's
    does: close() alone mutates _closed."""
    from repro_torch.serving import transport
    assert set(transport._Channel.GUARDED_BY) == {"_tokens"}
    rel = "src/repro_torch/serving/transport.py"
    assert concurrency_rules.scan_source(
        rel, (REPO / rel).read_text()) == []


@pytest.mark.parametrize("which", ["spec_a", "spec_b"])
def test_static_of_equals_the_jax_packages(which):
    from repro.sim import jaxsim as jax_sim
    spec = dict(zip(("spec_a", "spec_b"),
                    trace_rules.static_key_specs()))[which]
    jspec = jax_sim.JaxSimSpec(**dataclasses.asdict(spec))
    for kw in ({}, {"n_stream": 5, "lead": 2.0, "has_arrive": True},
               {"n_stream": 2048}):
        ours = jaxsim._static_of(spec, n_servers=1, max_lat=0.05, **kw)
        theirs = jax_sim._static_of(jspec, n_servers=1, max_lat=0.05, **kw)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_td003_spec_pair_changes_every_traced_field():
    a, b = trace_rules.static_key_specs()
    assert a.scheduler != b.scheduler
    for f in jaxsim.TRACED_FIELDS:
        assert getattr(a, f) != getattr(b, f), f


def test_td002_device_engine_init_takes_no_default_dtype():
    """TD002 found the device-sharded engine's initial exchange built from
    the default dtype; it is float32 now, so both defaults dispatch the
    same ops."""
    entry = next(e for e in trace_rules.default_trace_entries()
                 if e.name == "device-engine-trip")
    a = trace_rules.record_entry(entry, torch.float32)
    b = trace_rules.record_entry(entry, torch.float64)
    assert [o.signature for o in a.ops] == [o.signature for o in b.ops]


def test_td004_reads_every_stream_buffer():
    entry = trace_rules.default_load_entries()[0]
    buffers, run = entry.build()
    rec, _ = graph_tools.record(run)
    for name in ("conf", "cl", "ch", "dev_latency", "slo", "scheduler",
                 "a", "init_threshold"):
        assert graph_tools._storage_key(buffers[name]) in rec.read_keys, \
            name


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------
def test_recorder_versions_a_base_on_a_write_into_its_view():
    x = torch.zeros(4, dtype=torch.float32)
    y = torch.ones(2, dtype=torch.float32)
    rec = graph_tools.Recorder()
    rec.name("x", x)
    rec.name("y", y)
    x0 = rec.node_of(x)
    with rec:
        x[:2].copy_(y)
        z = x * 2.0
    assert rec.node_of(x) != x0
    assert rec.backward_slice(rec.node_of(x)) >= {x0, rec.node_of(y)}
    assert rec.node_of(y) in rec.backward_slice(rec.node_of(z))
    assert [o.name for o in rec.ops] == ["slice", "copy_", "mul"]
    assert rec.ops[-1].scalars == (2.0,)


def test_recorder_value_free_ops_depend_on_nothing():
    x = torch.ones(3, dtype=torch.float32)
    rec = graph_tools.Recorder()
    rec.name("x", x)
    with rec:
        z = torch.zeros_like(x)
    assert rec.backward_slice(rec.node_of(z)) == {rec.node_of(z)}


def test_recorder_tags_the_innermost_source_frame():
    def inner(t):
        return t.double()

    rec, _ = graph_tools.record(inner, torch.ones(2, dtype=torch.float32))
    (op,) = graph_tools.float64_ops(rec)
    assert op.site.path == "tests/test_torch_analysis.py"
    assert op.site.symbol.endswith("inner")


# ---------------------------------------------------------------------------
# the HD rules' dataflow and exemptions
# ---------------------------------------------------------------------------
HD_CASES = {
    "numpy_item_is_no_sync": ("""
        import numpy as np
        def f(a):
            x = np.asarray(a)
            return x.sum().item(), int(x.max())
        """, []),
    "tensor_item_syncs": ("""
        import torch
        def f(a):
            x = torch.as_tensor(a)
            return x.sum().item()
        """, ["HD002"]),
    "self_attribute_dict_of_tensors": ("""
        import torch
        class E:
            def __init__(self):
                self.st = {"active": torch.zeros(3, dtype=torch.bool)}
            def run(self):
                return bool(self.st["active"].any())
        """, ["HD002"]),
    "method_returning_a_tensor": ("""
        import torch
        class E:
            def _mask(self):
                return torch.ones(2)
            def done(self):
                return bool(self._mask().all())
        """, ["HD002"]),
    "captured_region_is_exempt": ("""
        import functools, torch
        @functools.lru_cache(maxsize=None)
        def capture(fn, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn(torch.tensor([1.0], device="cuda"))
            return g
        """, ["HD002"]),
    "lru_cache_memoizes_a_capture": ("""
        import functools, torch
        @functools.lru_cache(maxsize=None)
        def make():
            return torch.cuda.CUDAGraph()
        """, []),
    "compile_inside_a_function": ("""
        import torch
        def make(fn):
            return torch.compile(fn)
        """, ["HD003"]),
    "compile_of_a_lambda": ("""
        import torch
        def make():
            return torch.compile(lambda x: x.sum())
        """, ["HD003"]),
    "grad_argument_names_are_host_code": ("""
        import torch
        def loss(x):
            return torch.as_tensor(x).item()
        def step(p):
            return torch.autograd.grad(loss(p), [p])
        """, ["HD002"]),
    "blocking_copy_in_a_comprehension": ("""
        import torch
        def load(arrays, dev):
            return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        """, ["HD001", "HD002"]),
    "device_kwarg_copy_outside_a_loop": ("""
        import torch
        def const(dev):
            return torch.tensor([1, 2, 4], device=dev)
        """, ["HD002"]),
    "cpu_tensor_is_no_copy": ("""
        import torch
        def const():
            return torch.tensor([1, 2, 4], device="cpu")
        """, []),
    "cuda_method_in_a_loop": ("""
        def up(xs):
            return [x.cuda(non_blocking=True) for x in xs]
        """, ["HD001"]),
    "engine_loop_may_call_its_trip": ("""
        def run(eng):
            eng.trip()
        """, ["HD004"]),
    "synchronize_call": ("""
        import torch
        def wait():
            torch.cuda.synchronize()
        """, ["HD002"]),
}


@pytest.mark.parametrize("name", sorted(HD_CASES))
def test_hd_rules_on_small_cases(name):
    src, want = HD_CASES[name]
    got = sorted({f.rule for f in host_rules.scan_source(
        "case.py", textwrap.dedent(src))})
    assert got == sorted(want), (name, got)


def test_hd004_exempts_the_engine_loop_in_the_engine_file():
    src = "class _Engine:\n    def run(self):\n        self.trip()\n"
    assert host_rules.scan_source(host_rules.ENGINE_FILE, src) == []
    assert [f.rule for f in host_rules.scan_source("x.py", src)] == \
        ["HD004"]


def test_hd_symbols_are_qualified_names():
    src = ("import torch\nclass C:\n    def m(self, x):\n"
           "        return torch.as_tensor(x).item()\n")
    (f,) = host_rules.scan_source("c.py", src)
    assert (f.rule, f.symbol) == ("HD002", "C.m")


# ---------------------------------------------------------------------------
# the runtime guards' bookkeeping (the card runs them in chip_smoke.py)
# ---------------------------------------------------------------------------
def test_sync_census_unlisted_names_sites_without_an_hd002_entry():
    """Each sync must sit on a line the static HD002 rule flags and the
    allowlist suppresses: a sync on another line of an allowlisted
    function (client.py:44) is not accounted for."""
    census = runtime.SyncCensus()
    client = "src/repro_torch/serving/client.py"
    a = graph_tools.Site(client, 43, "DeviceClient.run_local")
    b = graph_tools.Site("src/repro_torch/serving/cascade.py", 9, "f")
    c = graph_tools.Site(client, 44, "DeviceClient.run_local")
    census.sites.update({a: 3, b: 1, c: 1})
    entries = load_allowlist(str(ALLOWLIST))
    assert census.unlisted(entries, str(REPO)) == [b, c]
    assert census.unlisted(
        [e for e in entries if e.symbol != a.symbol], str(REPO)) == [b, a, c]
    assert census.total == 5
    assert census.by_symbol()[(a.path, a.symbol)] == 4


def test_capture_guard_counts_an_engine_on_the_cpu():
    spec = jaxsim.JaxSimSpec("multitasc++", 3, 7)
    streams, lat, slo, srv = trace_rules.sim_inputs(3, 7)
    with runtime.CaptureGuard() as g:
        out = jaxsim.run_sweep([spec, spec], streams, lat, slo, srv,
                               device="cpu")
    assert g.delta["graphs_captured"] == 0
    assert g.delta["engines_built"] in (0, 1)
    assert np.all(out["completed"] == 21)


def test_float64_on_card_names_the_site_on_the_cpu():
    eng = trace_rules.build_engine()
    found = runtime.float64_on_card("engine-trip", trace_rules.engine_trip,
                                    eng)
    entries = load_allowlist(str(ALLOWLIST))
    kept, suppressed = apply_allowlist(found, entries)
    assert kept == [] and {f.symbol for f in suppressed} == \
        {"_fma32", "update"}
    assert all(isinstance(f, Finding) for f in found)
