"""TD003 corpus: a traced per-point value leaks into the capture key, so
every sweep point would build its own engine and capture its own graph."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class _Spec:
    n_devices: int = 4
    a: float = 0.05            # traced control gain


def _static_of(spec):
    # BUG: the traced gain is part of the static key
    return (spec.n_devices, spec.a)


LINT_STATIC_KEY_ENTRIES = [{
    "name": "corpus-leaky-key",
    "static_of": _static_of,
    "spec_a": _Spec(),
    "spec_b": _Spec(a=0.1),
    "traced_fields": ("a",),
}]
