"""The work counts against hand counts at the configuration's shapes; the
sides take a step's counts from the configuration's reference module."""
import json
from types import SimpleNamespace

from conftest import ROOT

from muxbench import bench, work


def model(name):
    return json.loads((ROOT / "muxbench" / "configs" / f"{name}.json")
                      .read_text())["model"]


def test_danube_counts():
    m = model("h2o-danube-1.8b")
    # a layer: q 2560x2560, k and v 2560x640 each, o 2560x2560, FFN 3 x
    # 2560x6912; the head 2560x32000
    layer = 2560 * 2560 * 2 + 2560 * 640 * 2 + 3 * 2560 * 6912
    tok = 2 * (24 * layer + 2560 * 32000)
    assert work.token_matmul_flops(m) == tok
    # decode at position 3000: 3001 keys, 4 x 32 heads x 80 a key a layer
    assert work.decode_step_flops(m, 8, 3000) == 8 * (
        tok + 4 * 24 * 32 * 80 * 3001)
    # the window caps the keys
    assert work.visible_keys(5000, m) == 4096
    keys = 512 * 513 // 2
    assert work.train_step_flops(m, 8, 512) == 3 * 8 * (
        512 * tok + 4 * 24 * 32 * 80 * keys)
    # decode attention: 8 rows x 3001 keys x (k, v) x 8 heads x 80, bf16,
    # plus q and out of 32 heads
    assert work.decode_attention_bytes(m, 8, 3001) == 8 * (
        2 * 3001 * 8 * 80 + 2 * 32 * 80) * 2


def test_counts_without_a_window():
    m = dict(model("h2o-danube-1.8b"), window=None)
    assert work.visible_keys(5000, m) == 5001
    # under the window every query sees all the keys before it
    assert work.train_step_flops(m, 8, 512) == work.train_step_flops(
        model("h2o-danube-1.8b"), 8, 512)


def test_bound_picks_the_slower_side():
    ms, by = work.bound(3.35e9, {"bf16": (1e9, 989e12)})
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = work.bound(0.0, {"bf16": (989e12, 989e12)})
    assert by == "operations" and abs(ms - 1e3) < 1e-9


def test_sides_take_the_counts_of_the_reference_module():
    """danube's reference gives `work.py`'s counts, to the bit; a stub
    reference's counts are what the sides report."""
    m = model("h2o-danube-1.8b")
    ref = bench.load_module(ROOT / "muxbench" / "reference" / "gqa_decoder.py")
    online = bench.load_module(ROOT / "muxbench" / "sides"
                               / "decode_sessions.py")
    offline = bench.load_module(ROOT / "muxbench" / "sides" / "train_step.py")
    spec = {"sessions": 8, "prompt_len": 2048, "cache_rows": 4352}
    ctx = SimpleNamespace(ref=ref, model=m, dtype_name="bfloat16")
    got = online.Side(ctx, spec).work(953)
    ms, _ = work.bound(work.decode_attention_bytes(m, 8, 3002),
                       {"mm": (work.decode_attention_flops(m, 8, 3002),
                               989e12)})
    assert got == {"flops": work.decode_step_flops(m, 8, 3001),
                   "least_s": {"decode_attention": 24 * ms / 1e3}}
    train = offline.Side(ctx, {"batch": 2, "seq": 2048}).work(0)
    assert train == {"flops": work.train_step_flops(m, 2, 2048),
                     "least_s": {}, "tokens": 4096}

    class Stub:
        @staticmethod
        def decode_step_work(m, batch, pos, dtype):
            return {"flops": float(batch * pos), "least_s": {"k": 1.0}}

        @staticmethod
        def train_step_work(m, batch, seq, dtype):
            return {"flops": 7.0, "least_s": {"k2": 2.0}}
    ctx.ref = Stub
    assert online.Side(ctx, spec).work(2) == {"flops": 8.0 * 2050,
                                              "least_s": {"k": 1.0}}
    assert offline.Side(ctx, {"batch": 2, "seq": 8}).work(0) == {
        "flops": 7.0, "least_s": {"k2": 2.0}, "tokens": 16}


def test_ctx2k_attention_work():
    """B2 x 2048 holds the tokens of B8 x 512 with 4x the causal keys a
    query sees: about 5 % more model FLOPs a step."""
    m = model("h2o-danube-1.8b")
    short, long = work.train_step_flops(m, 8, 512), \
        work.train_step_flops(m, 2, 2048)
    keys = (2 * 2048 * 2049 // 2) / (8 * 512 * 513 // 2)
    assert abs(keys - 4.0) < 0.01
    assert 1.03 < long / short < 1.07


def test_smoke_sizes_come_from_the_configuration():
    """The CPU tests' sizes are the configuration file's `smoke`; a run
    reads `model` alone."""
    from conftest import bench_json, smoke_parts
    for cell in bench_json()["workloads"]:
        parts = smoke_parts(cell["name"])
        config = json.loads((ROOT / [c["file"] for c in bench_json()["configs"]
                                     if c["name"] == cell["config"]][0])
                            .read_text())
        assert parts["config"]["model"] == {**config["model"],
                                            **config["smoke"]}
        full = bench.resolve(bench_json(), cell["name"])["config"]["model"]
        assert full == config["model"]
