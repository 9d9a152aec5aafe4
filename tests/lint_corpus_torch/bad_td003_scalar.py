"""TD003 corpus: a traced per-point value reaches an op of the trip as a
Python scalar — a captured graph would replay it for every later run of
the same structure. The capture key itself stays clean."""
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class _Spec:
    n_devices: int = 4
    a: float = 0.05            # traced control gain


def _static_of(spec):
    return (spec.n_devices,)


def _run(spec):
    thresh = torch.zeros(spec.n_devices, dtype=torch.float32)

    def trip():
        # BUG: the gain should arrive as a tensor filled per run
        thresh.add_(spec.a)
    return trip


LINT_STATIC_KEY_ENTRIES = [{
    "name": "corpus-baked-scalar",
    "static_of": _static_of,
    "spec_a": _Spec(),
    "spec_b": _Spec(a=0.0173828125),
    "traced_fields": ("a",),
    "run": _run,
}]
