"""The record of how a configuration was cut from its published model,
and the check that the cut keeps to the floors.

A configuration file (`muxbench/configs/<name>.json`) holds the published
model's keys (`published`), the port's sizes as run (`model`), and
`model_keys`, which names for each published key the port's key that
holds it.  Each entry of its `reduced` is {"key": the port's key,
"source_key": the published key, "published": its value there, "held":
the value held here}, and the configuration's entry in BENCHMARK.json
lists the same `source_key`s.  `deployment` says over how many chips each
layer is divided (`chips_per_layer`) and how (`how`); `assumed` gives each
size that the source does not.

A cut is the chip's share of that deployment, and the depth of a pipeline
stage:
  * layers (`num_layers`): whole periods of the layer pattern past the
    leading dense layers (`first_k_dense_replace` in `published`), and at
    least 4 past them;
  * routed experts held (`experts_held`, at least 8) and heads held
    (`num_heads`, `num_kv_heads`): the published count over
    `chips_per_layer`;
  * vocabulary rows (`vocab_size`): at least an eighth.
No width is ever cut: hidden, head, latent, rotary, FFN and expert widths,
experts per token, the router's outputs, the window.  Every published key
that is not cut holds its published value.
"""
from __future__ import annotations

import re

WIDTHS = {"d_model", "head_dim", "kv_lora_rank", "rope_head_dim", "d_ff",
          "moe_d_ff", "top_k", "num_experts", "window"}
WIDTH_NAME = re.compile(r"(_dim|_rank|_size|_width|_factor)$|^d_|"
                        r"intermediate|latent|state|experts_per_tok|window|"
                        r"expand")
SHARES = {"experts_held", "num_heads", "num_kv_heads"}
RECORD = {"key", "source_key", "published", "held"}
MIN_EXPERTS, MIN_PAST_DENSE, MIN_VOCAB_SHARE = 8, 4, 8


def is_width(key: str) -> bool:
    return key in WIDTHS or (key != "vocab_size"
                             and bool(WIDTH_NAME.search(key)))


def problems(entry: dict, config: dict, period: int) -> list[str]:
    """What is wrong with the configuration file `config`'s record of its
    cut, against its BENCHMARK.json `entry`; `period` is the length of its
    layer pattern.  Empty where the record is whole and the cut allowed."""
    out = []
    pub, model = config["published"], config["model"]
    records = config["reduced"]
    dep = config.get("deployment")
    if not isinstance(dep, dict) or not isinstance(
            dep.get("chips_per_layer"), int) or dep["chips_per_layer"] < 1 \
            or not dep.get("how"):
        out.append("deployment must give chips_per_layer and how")
        chips = 1
    else:
        chips = dep["chips_per_layer"]
    if not isinstance(config.get("assumed"), dict):
        out.append("assumed must give each size the source does not")
    if sorted(entry["reduced"]) != sorted(r.get("source_key")
                                          for r in records):
        out.append(f"BENCHMARK.json's reduced {entry['reduced']} is not the "
                   "file's source keys")
    cut = set()
    for r in records:
        if set(r) != RECORD:
            out.append(f"{r}: a record holds exactly {sorted(RECORD)}")
            continue
        key, src, held = r["key"], r["source_key"], r["held"]
        cut.add(key)
        if pub.get(src) != r["published"]:
            out.append(f"{src}: published {pub.get(src)!r}, the record "
                       f"says {r['published']!r}")
        if model.get(key) != held:
            out.append(f"{key}: the model holds {model.get(key)!r}, the "
                       f"record says {held!r}")
        if is_width(key) or is_width(src):
            out.append(f"{key} ({src}) is a width: no width is cut")
            continue
        if not isinstance(held, int) or not 0 < held < r["published"]:
            out.append(f"{key}: {held!r} is no cut of {r['published']!r}")
            continue
        out += floor(key, held, r["published"], pub, chips, period)
    for src, key in config.get("model_keys", {}).items():
        if key not in cut and model.get(key) != pub.get(src):
            out.append(f"{key} holds {model.get(key)!r} and {src} is "
                       f"published {pub.get(src)!r}, and it is not reduced")
    return out


def floor(key: str, held: int, published: int, pub: dict, chips: int,
          period: int) -> list[str]:
    """What breaks the floor of cutting `key` from `published` to `held`."""
    if key == "num_layers":
        lead = pub.get("first_k_dense_replace", 0)
        past = held - lead
        if past < max(period, MIN_PAST_DENSE) or past % period:
            return [f"num_layers {held}: keep whole periods of {period} "
                    f"past the {lead} leading dense layers, at least "
                    f"{MIN_PAST_DENSE}"]
        return []
    if key in SHARES:
        if held * chips != published:
            return [f"{key} {held}: not the share of {published} over "
                    f"{chips} chips"]
        if key == "experts_held" and held < MIN_EXPERTS:
            return [f"experts_held {held}: hold at least {MIN_EXPERTS}"]
        return []
    if key == "vocab_size":
        if held * MIN_VOCAB_SHARE < published:
            return [f"vocab_size {held}: hold at least 1/{MIN_VOCAB_SHARE} "
                    f"of {published}"]
        return []
    return [f"{key}: not a cut the floors allow (layers, experts held, "
            "heads held, vocabulary rows)"]


def period_of(config: dict) -> int:
    """The length of the port's layer pattern for the configuration."""
    from muxbench import bench
    return len(bench.port_config(config).pattern)
