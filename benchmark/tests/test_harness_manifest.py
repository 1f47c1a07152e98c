"""BENCHMARK.json and the files it names keep the contract's rules."""

import json

import pytest

from benchmark.core import manifest as M

MAN = M.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_limits():
    assert tuple(MAN) == M.TOP_KEYS
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) < 64 * 1024
    # a full check of 24 cells fits: 2 + 14 * cells runs, 2 x 90 s to compile per cell
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units_use_only_the_allowed_characters():
    assert M.names_problems(MAN) == []


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "é", "", "x" * 65, ".a"])
def test_the_name_rule_refuses(bad):
    man = json.loads(json.dumps(MAN))
    man["workloads"][0]["name"] = bad
    assert M.names_problems(man)


def test_entries_have_just_their_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for text in ([c["why"] for c in MAN["configs"]] + [w["why"] for w in MAN["workloads"]]
                 + [m["layer"] for m in MAN["per_layer"]] + MAN["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in M.end_to_end_of(MAN, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = M.per_layer_of(MAN, cell)
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_file_holds_its_driver_parameters_and_limits(cell):
    work = M.workload_file(cell)
    assert set(work) == {"driver", "params", "limits"}, "config and traffic live in BENCHMARK.json"
    assert (M.BENCH_DIR / "drivers" / f"{work['driver']}.py").exists()
    assert work["limits"], "a cell holds every compared number to a limit"


@pytest.mark.parametrize("name", [m["name"] for m in MAN["per_layer"]])
def test_each_metric_file_declares_what_the_manifest_says(name):
    entry = next(m for m in MAN["per_layer"] if m["name"] == name)
    mod = M.metric_module(name)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_files_hold_the_published_settings(entry):
    import dataclasses

    from supernet_tpu_torch import configs

    conf = M.config_file(entry)
    exp = configs.get_config(entry["name"])
    model = dataclasses.asdict(exp.model)
    for k, v in conf["model"].items():
        assert model[k] == (tuple(v) if isinstance(v, list) else v), k
    for k, v in conf["train"].items():
        assert getattr(exp.train, k) == v, k
    assert conf["reduced"] == entry["reduced"] == []
    assert conf["source"] == entry["source"]
