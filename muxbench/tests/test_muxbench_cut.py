"""The record of a configuration's cut (`muxbench/cut.py`): a chip's share
of a stated deployment within the floors is accepted; a width cut, a
broken floor or a record that disagrees with the file is refused."""
import copy

import pytest

from muxbench import cut

# a DeepSeek-V2-Lite-like chip share: 8 of 64 experts on one of 8 chips,
# 14 of 27 layers (one leading dense layer), the whole vocabulary
PUBLISHED = {"num_hidden_layers": 27, "hidden_size": 2048,
             "n_routed_experts": 64, "num_experts_per_tok": 6,
             "moe_intermediate_size": 1408, "kv_lora_rank": 512,
             "num_attention_heads": 16, "vocab_size": 102400,
             "first_k_dense_replace": 1}
SHARE = {
    "published": PUBLISHED,
    "model_keys": {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
                   "n_routed_experts": "num_experts",
                   "num_experts_per_tok": "top_k",
                   "moe_intermediate_size": "moe_d_ff",
                   "kv_lora_rank": "kv_lora_rank",
                   "num_attention_heads": "num_heads",
                   "vocab_size": "vocab_size"},
    "model": {"num_layers": 14, "d_model": 2048, "num_experts": 64,
              "experts_held": 8, "top_k": 6, "moe_d_ff": 1408,
              "kv_lora_rank": 512, "num_heads": 16, "vocab_size": 102400},
    "reduced": [
        {"key": "num_layers", "source_key": "num_hidden_layers",
         "published": 27, "held": 14},
        {"key": "experts_held", "source_key": "n_routed_experts",
         "published": 64, "held": 8}],
    "deployment": {"chips_per_layer": 8, "how": "expert parallel over 8 "
                   "GPUs, the first of two pipeline stages"},
    "assumed": {},
}
ENTRY = {"reduced": ["num_hidden_layers", "n_routed_experts"]}


def with_cut(key, src, held, published=None, entry=None, **model):
    """SHARE with one more record (key, src, held) and ENTRY to match."""
    config = copy.deepcopy(SHARE)
    config["model"].update(model)
    config["model"][key] = held
    config["reduced"].append({"key": key, "source_key": src,
                              "published": published or PUBLISHED[src],
                              "held": held})
    return (entry or {"reduced": ENTRY["reduced"] + [src]}), config


def test_a_chip_share_is_accepted():
    assert cut.problems(ENTRY, SHARE, 1) == []
    # an eighth of the vocabulary, and the heads' share under tensor
    # parallelism, are cuts too
    assert cut.problems(*with_cut("vocab_size", "vocab_size", 12800), 1) == []
    assert cut.problems(*with_cut("num_heads", "num_attention_heads", 2),
                        1) == []


def test_a_whole_configuration_matches_what_is_published():
    whole = copy.deepcopy(SHARE)
    whole.update(reduced=[], deployment={"chips_per_layer": 1, "how": "one"})
    whole["model"].update(num_layers=27, experts_held=64)
    assert cut.problems({"reduced": []}, whole, 1) == []
    whole["model"]["d_model"] = 1024
    assert cut.problems({"reduced": []}, whole, 1)


@pytest.mark.parametrize("key,src,held", [
    ("d_model", "hidden_size", 1024),
    ("moe_d_ff", "moe_intermediate_size", 704),
    ("top_k", "num_experts_per_tok", 2),
    ("num_experts", "n_routed_experts", 8),
    ("kv_lora_rank", "kv_lora_rank", 256),
])
def test_a_width_is_never_cut(key, src, held):
    got = cut.problems(*with_cut(key, src, held), 1)
    assert any("is a width" in p for p in got), got


@pytest.mark.parametrize("edit,period,says", [
    # 1 leading dense layer and 3 past it: under 4
    (dict(num_layers=4), 1, "leading dense"),
    # a pattern of period 4: 1 + 6 layers is no whole period past the lead
    (dict(num_layers=7), 4, "whole periods"),
    # 4 experts held: under 8, and not 64 over 8 chips
    (dict(experts_held=4), 1, "share of 64"),
])
def test_a_broken_floor_is_refused(edit, period, says):
    config = copy.deepcopy(SHARE)
    config["model"].update(edit)
    for r in config["reduced"]:
        r["held"] = config["model"][r["key"]]
    got = cut.problems(ENTRY, config, period)
    assert any(says in p for p in got), got


def test_too_few_experts_or_vocabulary_rows_are_refused():
    # 64 experts over 16 chips: 4 a chip, the share but under the floor
    entry, config = ENTRY, copy.deepcopy(SHARE)
    config["deployment"]["chips_per_layer"] = 16
    config["model"]["experts_held"] = config["reduced"][1]["held"] = 4
    got = cut.problems(entry, config, 1)
    assert any("at least 8" in p for p in got), got
    got = cut.problems(*with_cut("vocab_size", "vocab_size", 12000), 1)
    assert any("1/8" in p for p in got), got


def test_a_record_that_disagrees_is_refused():
    # BENCHMARK.json does not list the cut
    assert cut.problems({"reduced": ["num_hidden_layers"]}, SHARE, 1)
    # the model holds another value than the record says
    config = copy.deepcopy(SHARE)
    config["model"]["num_layers"] = 13
    assert any("the record says" in p for p in cut.problems(ENTRY, config, 1))
    # a published key changed without a record
    config = copy.deepcopy(SHARE)
    config["model"]["num_heads"] = 8
    assert any("not reduced" in p for p in cut.problems(ENTRY, config, 1))
    # a cut of a key the floors do not name
    got = cut.problems(*with_cut("rope_theta", "rope_theta", 100,
                                 published=10000), 1)
    assert any("not a cut the floors allow" in p for p in got), got
    # no deployment stated
    config = copy.deepcopy(SHARE)
    del config["deployment"]
    assert any("deployment" in p for p in cut.problems(ENTRY, config, 1))
