"""BENCHMARK.json resolves, by name, to the harness's files; every
configuration's record of its cut keeps to the floors; and a new mix,
metric or cut configuration is found by adding files and entries alone."""
import json
import re
import shutil

from pytest import approx

from conftest import ROOT, bench_json, smoke_parts, smoke_run

from muxbench import bench, cut

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


def test_every_cut_is_recorded_and_keeps_the_floors():
    """Each configuration's `reduced` is BENCHMARK.json's list of the
    published keys it cuts, and its file records each cut (`muxbench/
    cut.py`); a configuration that cuts nothing holds every published
    value."""
    for c in bench_json()["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert cut.problems(c, config, cut.period_of(config)) == [], c["name"]


def test_a_cell_sets_its_own_limits_over_the_configuration():
    """`muxbench/limits/<cell>.json` names only numbers the configuration
    limits and sets them for that cell alone; the other cells hold the
    configuration's limits."""
    b = bench_json()
    cells = {c["name"] for c in b["workloads"]}
    for f in (ROOT / "muxbench" / "limits").glob("*.json"):
        assert f.stem in cells, f
    for cell in cells:
        parts = bench.resolve(b, cell)
        own = ROOT / "muxbench" / "limits" / f"{cell}.json"
        given = json.loads(own.read_text()) if own.exists() else {}
        assert set(given) <= set(parts["config"]["limits"])
        assert parts["limits"] == {**parts["config"]["limits"], **given}
    ctx2k = bench.resolve(b, "danube-1.8b.share-ctx2k")["limits"]
    assert ctx2k["grad_leaf_rel"] == 0.005
    assert bench.resolve(b, "danube-1.8b.share-poisson")["limits"][
        "grad_leaf_rel"] == 0.0025


def test_a_new_mix_and_metric_need_no_edit(tmp_path):
    """A throwaway mix and metric, in a copy of the harness, resolve and
    read without a change to any file that is there; so does a throwaway
    configuration cut to a chip's share, with its own record of the cut,
    CPU sizes, reference (whose work counts the sides take) and reader,
    and a run of it on the CPU."""
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

    add_cut_configuration(copy, b)
    entry = b["configs"][-1]
    config = json.loads((copy.parent / entry["file"]).read_text())
    assert cut.problems(entry, config, cut.period_of(config)) == []
    parts = smoke_parts("danube-cut.share-poisson", spec=b, base=copy)
    assert parts["reference"] == copy / "reference" / "cut_stub.py"
    assert parts["config"]["model"]["num_layers"] == 4
    out = smoke_run("danube-cut.share-poisson", parts=parts, trace=True,
                    seconds=1.0)
    assert out["correct"], out["checks"]
    online = [s for s in out["_record"].spans if s.kind == "online"]
    assert out["metrics"]["stub_kernel_ms"]["value"] == approx(len(online))
    for p, data in before.items():
        assert p.read_bytes() == data, p


def add_cut_configuration(copy, b: dict) -> None:
    """Files and entries of a configuration cut to 4 of danube's 24
    layers and an eighth of its vocabulary: its file, a reference that
    takes danube's and counts one stub kernel a step, a reader of that
    kernel's least time, and a cell."""
    config = json.loads((copy / "configs" / "h2o-danube-1.8b.json")
                        .read_text())
    config.update(name="danube-cut", reference="cut_stub", reduced=[
        {"key": "num_layers", "source_key": "num_hidden_layers",
         "published": 24, "held": 4},
        {"key": "vocab_size", "source_key": "vocab_size",
         "published": 32000, "held": 4000}])
    config["model"].update(num_layers=4, vocab_size=4000)
    config["smoke"].update(num_layers=4, vocab_size=200)
    config["deployment"]["how"] = "the first of six pipeline stages"
    (copy / "configs" / "danube-cut.json").write_text(json.dumps(config))
    (copy / "reference" / "cut_stub.py").write_text(
        "from muxbench.reference.gqa_decoder import *  # noqa: F403\n"
        "from muxbench.reference import gqa_decoder as G\n\n\n"
        "def decode_step_work(m, batch, pos, dtype):\n"
        "    return {'flops': G.decode_step_work(m, batch, pos, dtype)"
        "['flops'],\n"
        "            'least_s': {'stub_kernel': 1e-3}}\n")
    (copy / "metrics" / "stub_kernel_ms.py").write_text(
        "def read(rd):\n"
        "    return 1e3 * sum(s.work['least_s']['stub_kernel']\n"
        "                     for s in rd.rec.spans if s.kind == 'online')\n")
    b["configs"].append({"name": "danube-cut", "source": "x",
                         "file": "muxbench/configs/danube-cut.json",
                         "reduced": ["num_hidden_layers", "vocab_size"],
                         "why": "x"})
    b["workloads"].append({"name": "danube-cut.share-poisson",
                           "config": "danube-cut", "traffic": "share-poisson",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "stub_kernel_ms", "unit": "ms",
                           "better": "higher", "source": "host_clock",
                           "layer": "model decode step",
                           "moves": "online_p95_ms",
                           "workloads": ["danube-cut.share-poisson"]})
