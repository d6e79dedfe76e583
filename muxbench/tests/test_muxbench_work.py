"""The work counts against hand counts at the configuration's shapes."""
import json

from conftest import ROOT

from muxbench import work


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
