"""BENCHMARK.json resolves, by name, to the harness's files, and a new mix
or metric is found by adding files and entries alone."""
import json
import re
import shutil

from conftest import ROOT, bench_json

from muxbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves_to_its_files():
    b = bench_json()
    for cell in b["workloads"]:
        parts = bench.resolve(b, cell["name"])
        assert parts["config"]["name"] == cell["config"]
        assert parts["mix"]["name"] == cell["traffic"]
        assert (ROOT / "muxbench" / "reference"
                / f"{parts['config']['reference']}.py").exists()
        for path in list(parts["readers"].values()) + list(
                parts["sides"].values()):
            assert path.exists(), path
        assert {m["name"] for m in parts["e2e"]} >= {"setup_s"}
        assert len(parts["e2e"]) >= 2 and parts["per_layer"]


def test_names_units_and_arrows():
    b = bench_json()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"online_p95_ms", "offline_tokens_per_s", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]] + [
        c["name"] for c in b["workloads"] + b["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        # every cell that reports the metric reports what it moves
        reporting = set(e2e[m["moves"]].get(
            "workloads", [c["name"] for c in b["workloads"]]))
        assert set(m["workloads"]) <= reporting
    assert all(c["chips"] == 1 for c in b["workloads"])
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists() and c["reduced"] == []


def test_a_new_mix_and_metric_need_no_edit(tmp_path):
    """A throwaway mix and metric, in a copy of the harness, resolve and
    read without a change to any file that is there."""
    copy = tmp_path / "muxbench"
    shutil.copytree(ROOT / "muxbench", copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    b = bench_json()
    mix = json.loads((copy / "mixes" / "share-poisson.json").read_text())
    mix.update(name="online-only")
    mix.pop("offline")
    (copy / "mixes" / "online-only.json").write_text(json.dumps(mix))
    (copy / "metrics" / "steps_online.py").write_text(
        "def read(rd):\n"
        "    return float(sum(s.kind == 'online' for s in rd.rec.spans))\n")
    b["workloads"].append({"name": "danube-1.8b.online-only",
                           "config": "h2o-danube-1.8b",
                           "traffic": "online-only", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "steps_online", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "model decode step",
                           "moves": "online_p95_ms",
                           "workloads": ["danube-1.8b.online-only"]})
    parts = bench.resolve(b, "danube-1.8b.online-only", base=copy)
    assert set(parts["sides"]) == {"online"}
    assert [m["name"] for m in parts["per_layer"]] == ["steps_online"]
    reader = bench.load_module(parts["readers"]["steps_online"])

    class Rd:
        class rec:
            spans = []
    assert reader.read(Rd) == 0.0
    for p, data in before.items():
        assert p.read_bytes() == data, p
