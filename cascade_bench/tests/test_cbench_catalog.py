"""Every cell, configuration, traffic mix, limit file and metric reader
loads by name, and BENCHMARK.json keeps to the shape the harness reads."""
import json
import math
import re

import pytest

from cascade_bench import catalog, check, weights

BENCH = catalog.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|"
                   r"_rank$|d_model|d_ff|expan|experts_per_tok)")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    c = catalog.load_cell(cell)
    assert c.chips == 1
    assert c.config["dtype"] == "float32"
    assert set(c.limits) == set(check.NUMBERS)
    # under what an answer of another class reads (4 and more, on the card)
    assert c.limits["sample_err_p90"] < c.limits["sample_err_max"] < 2
    assert c.traffic["window_opens_at_s"] > 0
    assert [m["name"] for m in c.end_to_end] == \
        ["served_per_s", "batch_ms_p90", "setup_s"]
    assert len(c.per_layer) == 6


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(catalog.reader(metric))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    with open(catalog.ROOT / cfg["file"]) as f:
        body = json.load(f)
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert cfg["file"].startswith(BENCH["paths"][0] + "/")
    for key in cfg["reduced"]:
        assert key in body and key in body["reduced"]
        assert not WIDTH.search(key), key
    assert sum(math.prod(s) for _, s, _ in weights.layout(body)) > 1e9


def test_names_and_references():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c for c, _ in pairs} == configs
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
