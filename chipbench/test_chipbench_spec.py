"""``BENCHMARK.json`` and the files it names: its format (keys, names,
units, limits), each name leading to its file, each per-layer metric
moving an end-to-end metric its cells report, and no module here loading
JAX or the JAX package."""
import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def bench():
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def read(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["chipbench"]
    assert b["command"] == ["python3", "chipbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units():
    b = bench()
    names = [x["name"] for group in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in b[group]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher"), m
    for text in ([w["why"] for w in b["workloads"] + b["configs"]]
                 + [m["layer"] for m in b["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_and_their_cells():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        # every cell that reports the metric reports what it moves
        for cell in m.get("workloads", cells):
            assert cell in cells
            reports = e2e[m["moves"]].get("workloads", cells)
            assert cell in reports, (m["name"], cell)
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])
        assert any(cell in m.get("workloads", cells)
                   for m in b["end_to_end"] if m["name"] != "setup_s")


def test_each_name_leads_to_its_file():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["name"] in used, c["name"]
        assert c["file"].startswith("chipbench/")
        conf = read(ROOT / c["file"])
        assert conf["name"] == c["name"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert "smoke" not in conf
        assert c["source"] == conf["source"]
    for w in b["workloads"]:
        assert w["chips"] == 1
        traffic = read(HERE / "traffic" / f"{w['traffic']}.json")
        assert traffic["kind"] == "closed_batches"
        check = read(HERE / "cells" / f"{w['name']}.json")
        # two at least, so that the sample takes in both halves of a batch
        assert check["requests"] >= 2 and check["limits"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]


#: a width: a hidden, intermediate, latent, state or projection size, a
#: head size, an expansion factor, the experts a token takes
WIDTHS = re.compile(r"(_size|_dim|_rank|_factor|per_tok)\Z")


@pytest.mark.parametrize("name", [c["name"] for c in bench()["configs"]])
def test_each_configuration_as_run_is_the_ports_model(name):
    """The file keeps the source's keys; ``departures`` lays the port's
    equations over them, and what the program and the reference then run
    is the port's registry entry at the file's depth, reached through the
    file's family. ``reduced`` names cuts of scale only, never a width,
    each with its published value."""
    from chipbench import harness
    conf = read(ROOT / {c["name"]: c for c in bench()["configs"]}[name]
                ["file"])
    assert not any(WIDTHS.search(k) for k in conf["reduced"])
    assert set(conf["reduced"]) <= set(conf.get("published", {}))
    run_as = harness.as_run(conf)
    family = harness.family(run_as.get("family", "dense"))
    family.arch_config(run_as)
    family.reference(run_as, {})


def test_the_per_layer_layers_are_named_in_perf_md():
    text = (ROOT / "PERF.md").read_text(encoding="utf-8")
    for layer in {m["layer"] for m in bench()["per_layer"]}:
        assert f"| {layer} |" in text, layer


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in imported_modules(path)}
    assert not tops & set(FORBIDDEN), (path, tops & set(FORBIDDEN))


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        mods = set(imported_modules(path))
        assert not any(m.split(".")[0] == "repro_torch"
                       or m == "chipbench.program" for m in mods), path


def test_run_refuses_without_a_card_and_names_loaded_jax(monkeypatch,
                                                         capsys):
    import torch
    from chipbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", bench()["workloads"][0]["name"],
                     "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
    loaded = ["torch", "repro_torch.models", "jax.numpy", "repro.core",
              "flax", "jaxlib", "reprox"]
    assert run.forbidden_modules(loaded) == ["flax", "jax.numpy", "jaxlib",
                                             "repro.core"]


def test_run_looks_for_jax_after_the_metrics_and_the_comparison(
        monkeypatch, capsys):
    """What the metric readers or the comparison load is looked for too:
    the look comes last, and a find prints no result."""
    import torch
    from chipbench import harness, run
    order = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "serve", lambda *a, **k: (None, [], {}))
    monkeypatch.setattr(harness, "read_metrics",
                        lambda *a: order.append("metrics") or {})
    monkeypatch.setattr(harness, "check",
                        lambda *a: order.append("check") or ({}, 0))
    monkeypatch.setattr(run, "forbidden_modules",
                        lambda: order.append("look") or ["jax"])
    assert run.main(["--workload", bench()["workloads"][0]["name"],
                     "--seed", "1", "--seconds", "1"]) == 3
    assert order == ["metrics", "check", "look"]
    assert capsys.readouterr().out == ""
