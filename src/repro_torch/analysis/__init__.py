"""Static analysis for the port: the JAX package's ``analysis/`` gate
recast for an eager PyTorch program.

What JAX checks on a jaxpr, the port checks on the aten ops its entry
points dispatch (``graph_tools.Recorder``, a ``TorchDispatchMode``). Four
rule families, run by ``python -m repro_torch.analysis`` and pinned by
``tests/test_torch_analysis.py``:

* ``trace-discipline`` (TD*): record the real entry points (the
  simulator engine's trip, flat, with arrivals, segmented and
  device-sharded; the scheduler updates and the switching decision; the
  serving classify function; the four kernel wrappers) and check them for
  float64 ops, ops whose dtype follows the default dtype, traced
  per-point values reaching the capture key or an op as a Python scalar,
  and buffers the engine's load fills and nothing reads.
* ``host-dispatch`` (HD*): AST lint over every module of the port for
  host-to-device copies in host loops, host-device synchronizations,
  CUDA graphs or compiled functions made per call, and host calls into
  the engine's per-trip methods.
* ``lane-mask`` (LM*): from a recording of the engine's real trip
  (``jaxsim.lane_stepper``), every carry write is gated on the
  active-lane mask, and the window boundary writes only
  ``BOUNDARY_FIELDS`` and the trace rows.
* ``concurrency`` (CC*): the serving classes' ``GUARDED_BY`` lock maps
  are exact and every guarded mutation holds its lock.

``runtime`` holds the guards only a card can run (a census of the syncs
``torch.cuda.set_sync_debug_mode`` reports, each held to an allowlisted
HD002 site; the simulator's capture counters). The package imports
``torch`` and the standard library only and has no side effects at
import; recording happens only when the rules run.
"""
from repro_torch.analysis.findings import Finding, Severity  # noqa: F401
from repro_torch.analysis.driver import run_lint, all_rules  # noqa: F401
