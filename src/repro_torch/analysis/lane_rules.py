"""Lane-masking invariant rules (LM*), checked on the engine's real trip.

The checked object is the trip the engine runs: ``jaxsim.lane_stepper``
hands out a one-trip ``step`` that is the engine's own ``trip`` (not a
mirror of it), on the CPU. ``step(state)`` is recorded by
``graph_tools.Recorder``, with every leaf of ``state`` labelled as a root;
its result's leaves are the carry buffers' final versions:

* LM001: every carry buffer's final version is either untouched (made
  only by copies of its own input) or has the ``active`` buffer in its
  backward slice. A write of real data that bypasses the predicate
  (``t = frontier``) depends on neither and fails, and a buffer
  overwritten with a constant depends on no input at all.
* LM002: the writes made while the boundary function (``_boundary``)
  runs land only on ``BOUNDARY_FIELDS`` and the trace rows: the forward
  taint of every node made inside it reaches no other carry buffer. A
  trip whose boundary writes nothing that reaches the carry fails too
  (the invariant would otherwise pass vacuously on a rewritten engine).

Entries cover the flat engine, the engine with arrivals and the segmented
one (``n_devices >= SEG_AUTO_MIN``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

from repro_torch.analysis import graph_tools as gt
from repro_torch.analysis.findings import Finding, Severity

FAMILY = "lane-mask"
ACTIVE = "active"          # the carry's active-lane predicate
TRACES = "traces"          # the carry's trace rows
BOUNDARY = "_boundary"     # the trip's window-boundary function


@dataclasses.dataclass
class LaneEntry:
    name: str
    body: Callable      # carry -> carry (one trip)
    st0: object         # example carry (nested dict of tensors)
    boundary_fields: Sequence[str]


def engine_lane_entry(name: str, n: int, s: int, arrive: bool = False,
                      seed: int = 0) -> LaneEntry:
    from repro_torch.analysis.trace_rules import sim_inputs
    from repro_torch.sim import jaxsim
    spec = jaxsim.JaxSimSpec("multitasc++", n, s, model_switching=True)
    streams, lat, slo, srv = sim_inputs(n, s, arrive, seed)
    st0, step, _ = jaxsim.lane_stepper(spec, streams, lat, slo, srv,
                                       device="cpu")
    return LaneEntry(name, step, st0,
                     boundary_fields=jaxsim.BOUNDARY_FIELDS)


def default_lane_entries() -> List[LaneEntry]:
    from repro_torch.analysis.trace_rules import LINT_N, LINT_S, SEG_N
    return [engine_lane_entry("lane-stepper", LINT_N, LINT_S),
            engine_lane_entry("lane-stepper-arrive", LINT_N, LINT_S,
                              arrive=True),
            engine_lane_entry("lane-stepper-seg", SEG_N, LINT_S)]


def _entry_path(entry: LaneEntry) -> str:
    return f"<entry:{entry.name}>"


def record_body(entry: LaneEntry):
    """Record ``entry.body(entry.st0)``: ``(recorder, [(path, input node,
    output node)])`` for every carry leaf."""
    rec = gt.Recorder()
    ins = gt.leaves(entry.st0)
    for path, t in ins:
        rec.name(path, t)
    in_nodes = {path: rec.node_of(t) for path, t in ins}
    with rec:
        out = entry.body(entry.st0)
    outs = dict(gt.leaves(out))
    if set(outs) != set(in_nodes):
        raise ValueError(
            f"lane entry {entry.name}: the body must map the carry to a "
            f"carry of the same leaves ({sorted(set(in_nodes) ^ set(outs))}"
            f" differ)")
    return rec, [(p, in_nodes[p], rec.node_of(outs[p])) for p, _ in ins]


def check_lane_entry(entry: LaneEntry) -> List[Finding]:
    """LM001 + LM002 on one body; the rule runners and the tests'
    mutated-trip checks share it."""
    rec, leaves = record_body(entry)
    return _check_masking(entry, rec, leaves) + \
        _check_boundary(entry, rec, leaves)


def _untouched(rec: gt.Recorder, node: int, own: int) -> bool:
    """Whether ``node`` is ``own`` or made from it by copies alone."""
    for n in rec.backward_slice(node):
        op = rec.op_of(n)
        if op is None:
            if n in rec.root_label and n != own:
                return False
        elif op.name not in gt.COPY_OPS:
            return False
    return True


def _check_masking(entry, rec, leaves) -> List[Finding]:
    active = f"['{ACTIVE}']"
    by_path = {p: i for p, i, _ in leaves}
    if active not in by_path:
        return [Finding(
            "LM001", FAMILY, Severity.ERROR, _entry_path(entry), 0,
            ACTIVE,
            f"carry has no {ACTIVE!r} buffer — the active-lane "
            f"predicate the masking invariant gates on is missing")]
    active_root = by_path[active]
    out: List[Finding] = []
    for path, own, node in leaves:
        if node is None or _untouched(rec, node, own):
            continue
        sl = rec.backward_slice(node)
        if active_root in sl:
            continue
        roots = [n for n in sl if rec.op_of(n) is None]
        if not roots:
            msg = ("carry buffer is overwritten with a constant — the "
                   "write is not gated on the active-lane predicate")
        else:
            msg = (f"carry write does not depend on the "
                   f"{ACTIVE!r} predicate: an inactive lane "
                   f"would keep stepping (unmasked write)")
        out.append(Finding("LM001", FAMILY, Severity.ERROR,
                           _entry_path(entry), 0, path, msg))
    return out


def _check_boundary(entry, rec, leaves) -> List[Finding]:
    made = [n for op in rec.ops
            if any(q.rsplit(".", 1)[-1] == BOUNDARY for q in op.stack)
            for n in op.made]
    tainted = rec.forward_taint(made)
    allowed = set(entry.boundary_fields) | {TRACES}
    reached = [(p, node) for p, _, node in leaves
               if node is not None and node in tainted]
    if not reached:
        return [Finding(
            "LM002", FAMILY, Severity.ERROR, _entry_path(entry), 0,
            "boundary",
            f"the trip's boundary ({BOUNDARY}) writes nothing that "
            f"reaches the carry — the window-boundary exchange the "
            f"invariant constrains is gone (or moved out of it)")]
    return [Finding(
        "LM002", FAMILY, Severity.ERROR, _entry_path(entry), 0, path,
        f"the boundary ({BOUNDARY}) reaches carry buffer {path} — "
        f"only BOUNDARY_FIELDS {tuple(entry.boundary_fields)} and "
        f"{TRACES!r} rows may be touched by the window boundary")
        for path, _ in reached if gt.top_level_key(path) not in allowed]


def _lane_findings(ctx) -> List[Finding]:
    cache = ctx.__dict__.get("_lane_cache")
    if cache is None:
        cache = []
        for entry in ctx.lane_entries:
            cache.extend(check_lane_entry(entry))
        ctx._lane_cache = cache
    return cache


def rule_lm001(ctx) -> List[Finding]:
    return [f for f in _lane_findings(ctx) if f.rule == "LM001"]


def rule_lm002(ctx) -> List[Finding]:
    return [f for f in _lane_findings(ctx) if f.rule == "LM002"]

