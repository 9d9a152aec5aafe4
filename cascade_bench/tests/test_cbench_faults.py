"""A whole run on the CPU at a test size, the chip's look skipped: it comes
out correct, and with the timed path broken underneath it comes out not
correct, once for each fault a serving cell can have."""
import numpy as np
import pytest
import torch

from cascade_bench import harness
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import ServerEngine
from repro_torch.serving.queue import RequestQueue

SEED = 2 ** 31 + 101


def run(cell):
    return harness.run_cell(cell, SEED, 1.5, False, device="cpu")


def altered_answer(monkeypatch):
    """The prediction of each batch's first sample changed where BvSB
    produces it."""
    orig = ops.bvsb

    def bvsb(logits):
        conf, top1 = orig(logits)
        top1 = top1.clone()
        top1[0] = (top1[0] + 1) % logits.shape[-1]
        return conf, top1
    monkeypatch.setattr(ops, "bvsb", bvsb)


def altered_answer_in_large_batches(monkeypatch):
    """The prediction of the last slot altered, only in batches of more
    than 4 samples: a fault of one slot while many are live."""
    orig = ops.bvsb

    def bvsb(logits):
        conf, top1 = orig(logits)
        if logits.shape[0] > 4:
            top1 = top1.clone()
            top1[-1] = (top1[-1] + 1) % logits.shape[-1]
        return conf, top1
    monkeypatch.setattr(ops, "bvsb", bvsb)


def unchanged_state(monkeypatch):
    """A step that hands back the state it had: each batch returns the
    results of the batch before it."""
    orig = ServerEngine.execute
    last = {}

    def execute(self, record):
        n = len(record["requests"])
        out = orig(self, record)
        prev = last.get("out")
        last["out"] = (out["conf"].copy(), out["pred"].copy())
        if prev is not None:
            out["conf"] = np.resize(prev[0], n)
            out["pred"] = np.resize(prev[1], n)
        return out
    monkeypatch.setattr(ServerEngine, "execute", execute)


def half_batch(monkeypatch):
    """Half of each batch left out: the forward runs on the first half and
    its rows stand in for the rest."""
    orig = Model.forward

    def forward(self, tokens, **kw):
        b = tokens.shape[0]
        if b < 2:
            return orig(self, tokens, **kw)
        logits, cache = orig(self, tokens[:(b + 1) // 2], **kw)
        return torch.cat([logits, logits])[:b], cache
    monkeypatch.setattr(Model, "forward", forward)


def served_twice(monkeypatch):
    """The queue hands out a batch's first request twice and drops the
    last one."""
    orig = RequestQueue.pop_batch

    def pop_batch(self, max_n):
        reqs = orig(self, max_n)
        if len(reqs) > 1:
            reqs[-1] = reqs[0]
        return reqs
    monkeypatch.setattr(RequestQueue, "pop_batch", pop_batch)


def test_sound_run_is_correct(tiny_cell):
    out = run(tiny_cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 50
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"served_per_s", "batch_ms_p90",
                                   "setup_s"}


@pytest.mark.parametrize("fault", [altered_answer,
                                   altered_answer_in_large_batches,
                                   unchanged_state, half_batch, served_twice],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(tiny_cell, monkeypatch, fault):
    fault(monkeypatch)
    out = run(tiny_cell)
    assert not out["correct"]
    assert out["failed"] >= 1
