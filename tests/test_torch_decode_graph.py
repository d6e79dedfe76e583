"""The decode step replayed from CUDA graphs (`models/decode_graph.py`).

On the CPU: the live buckets, and every call that the graphs do not take
(on the CPU, on the meta device) counted in `eager` and bitwise the eager
`forward(mode="decode")`.  On the card, at SMOKE sizes in bf16: the
replayed steps against the eager step on a copy of the same cache, over a
ring that wraps and over a plain cache, across bucket boundaries: logits
within the decode kernel's bf16 rule, the cache bitwise (at most 128 rows
the kernel takes one split whatever rows it is given, so the rows each
layer writes are the eager step's), the counters, a kept output left
alone by the next replay, no wait for the card in a replay, a position
past a plain cache raising, and a new cache dropping the graphs."""
import gc
import weakref

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import (forward, init_cache, init_params,
                                make_decode_step, make_prefill)
from repro_torch.models import decode_graph as DG
from repro_torch.models.model import Transformer

B, PROMPT = 2, 40
# the decode kernel against its plain version (tests/test_torch_kernels.py):
# the fp32 limit plus one rounding to bf16, half an ulp
BF16_RULE = 2e-5 + 2**-8


# ------------------------------------------------------------- the buckets

@pytest.mark.parametrize("cap,tile", [(4096, 32), (4096, 64), (4352, 32),
                                      (128, 64), (100, 32), (16, 64),
                                      (1, 32), (1000, 48)])
def test_live_buckets(cap, tile):
    """Multiples of cap / 8 rounded up to the tile's rows, the last equal
    to the capacity, and each live row count in (lo, hi] of its bucket."""
    buckets = DG.live_buckets(cap, tile)
    step = -(-(-(-cap // DG.BUCKETS)) // tile) * tile
    assert step % tile == 0 and step * DG.BUCKETS >= cap
    assert len(buckets) <= DG.BUCKETS and buckets[-1] == cap
    assert list(buckets[:-1]) == [step * (i + 1)
                                  for i in range(len(buckets) - 1)]
    assert all(a < b for a, b in zip(buckets, buckets[1:]))
    for live in range(1, cap + 1):
        hi = DG.live_bucket(live, cap, tile)
        i = buckets.index(hi)
        lo = buckets[i - 1] if i else 0
        assert lo < live <= hi


# ------------------------------------------------------- eager on the CPU

def prefilled(cfg, params, rows: int, seed: int = 1):
    """A decode cache of `rows` rows holding a prefill of PROMPT tokens, on
    the params' device."""
    dev = params.embed.device
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=g)
    _, pre = make_prefill(cfg)(params, {"tokens": prompt.to(dev)})
    cache = init_cache(cfg, B, rows, device=dev)
    for src, dst in zip(pre, cache):
        for name, t in src.items():
            dst[name][:, :, :t.shape[2]].copy_(t)
    return cache


def copy_of(cache):
    return tuple({k: t.clone() for k, t in c.items()} for c in cache)


def fed(cfg, steps: int, dev, seed: int = 2):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (steps, B, 1), generator=g).to(dev)


@pytest.mark.parametrize("arch,rows", [("h2o-danube-1.8b", 16),
                                       ("mistral-nemo-12b", 64),
                                       ("granite-moe-1b-a400m", 64),
                                       ("xlstm-350m", 64)])
def test_cpu_calls_are_eager_and_bitwise(arch, rows):
    """On the CPU every step is eager, and bitwise today's forward (the
    danube cache of 16 rows is its window's ring, and wraps)."""
    cfg = get_config(arch, smoke=True)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    cache = prefilled(cfg, params, rows)
    want_cache = copy_of(cache)
    step = make_decode_step(cfg)
    toks = fed(cfg, 8, "cpu")
    for i in range(8):
        pos = PROMPT + i
        got, cache = step(params, cache, toks[i], pos)
        want, want_cache = forward(params, cfg, {"tokens": toks[i]},
                                   mode="decode", cache=want_cache, pos=pos)
        assert torch.equal(got, want)
    for c, w in zip(cache, want_cache):
        for name in c:
            assert torch.equal(c[name], w[name])
    assert (step.eager, step.replays, step.captures) == (8, 0, 0)


def test_meta_calls_are_eager():
    """On the meta device (the dry-run's shapes) the step is eager."""
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    params = Transformer(cfg, torch.device("meta"))
    cache = init_cache(cfg, B, 64, device="meta")
    step = make_decode_step(cfg)
    logits, _ = step(params, cache, torch.zeros((B, 1), dtype=torch.long,
                                                device="meta"), 5)
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (B, cfg.padded_vocab)
    assert (step.eager, step.replays, step.captures) == (1, 0, 0)


# ---------------------------------------------------------------- the card

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import decode_attention as da
    return da


# (arch, config overrides, cache rows, positions of the steps): a ring of
# 128 rows crossing the bucket at 64 and wrapping at 128; a plain cache of
# 128 rows crossing 64 up to its last row
CARD_CASES = {
    "ring": ("h2o-danube-1.8b", {"window": 128}, 128, range(PROMPT, 200)),
    "plain": ("mistral-nemo-12b", {}, 128, range(PROMPT, 128)),
}


def card_model(case: str):
    arch, over, rows, positions = CARD_CASES[case]
    cfg = get_config(arch, smoke=True, **over)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    return cfg, params, prefilled(cfg, params, rows), positions


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((got - want).float())
                 / torch.linalg.vector_norm(want.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_replay_matches_eager(case):
    """Every replayed step within the bf16 rule of the eager step, the cache
    bitwise, and the counters: one eager warm-up, then replays that add a
    launch of the decode kernel a layer each."""
    da = card()
    cfg, params, cache, positions = card_model(case)
    want_cache = copy_of(cache)
    step = make_decode_step(cfg)
    toks = fed(cfg, len(positions), "cuda")
    tile = da.tile_rows(torch.device("cuda"), cfg.dtype, cfg.num_heads,
                        cfg.num_kv_heads, cfg.head_dim)
    rows = cache[0]["k"].shape[2]
    buckets = DG.live_buckets(rows, tile)
    assert len(buckets) > 1
    for n, pos in enumerate(positions):
        before = da.launches
        got, cache = step(params, cache, toks[n], pos)
        assert da.launches - before == cfg.num_layers
        want, want_cache = forward(params, cfg, {"tokens": toks[n]},
                                   mode="decode", cache=want_cache, pos=pos)
        assert rel(got, want) <= BF16_RULE, (pos, rel(got, want))
        for c, w in zip(cache, want_cache):
            for name in c:
                assert torch.equal(c[name], w[name]), (pos, name)
        if n == 0:
            first = DG.live_bucket(pos + 1, rows, tile)
            assert step.captures == len([b for b in buckets if b >= first])
    assert step.eager == 1
    assert step.replays == len(positions) - 1
    assert step.captures == len(buckets)


@pytest.mark.cuda
def test_kept_logits_survive_the_next_replay():
    card()
    cfg, params, cache, positions = card_model("plain")
    step = make_decode_step(cfg)
    toks = fed(cfg, 4, "cuda")
    kept = []
    for i in range(4):
        logits, cache = step(params, cache, toks[i], PROMPT + i)
        kept.append((logits, logits.clone()))
    torch.cuda.synchronize()
    assert step.replays == 3
    for logits, copy in kept:
        assert torch.equal(logits, copy)
    assert not torch.equal(kept[-1][0], kept[-2][0])


@pytest.mark.cuda
def test_replay_does_not_wait_for_the_card():
    """A replay, with an int pos and a host (B,) pos, under the sync
    debug mode that raises on any wait for the card."""
    card()
    cfg, params, cache, positions = card_model("plain")
    step = make_decode_step(cfg)
    toks = fed(cfg, 3, "cuda")
    step(params, cache, toks[0], PROMPT)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(params, cache, toks[1], PROMPT + 1)
        step(params, cache, toks[2],
             torch.tensor([PROMPT + 2, PROMPT + 1], dtype=torch.int32))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert step.replays == 2


@pytest.mark.cuda
def test_position_past_a_plain_cache_raises():
    card()
    cfg, params, cache, positions = card_model("plain")
    step = make_decode_step(cfg)
    tok = fed(cfg, 1, "cuda")[0]
    step(params, cache, tok, PROMPT)
    rows = cache[0]["k"].shape[2]
    with pytest.raises(ValueError, match="kv_len must lie in"):
        step(params, cache, tok, rows)
    assert step.replays == 0


@pytest.mark.cuda
def test_pos_on_the_card_is_eager():
    """A pos already on the card takes the eager path, bitwise forward."""
    card()
    cfg, params, cache, positions = card_model("plain")
    want_cache = copy_of(cache)
    step = make_decode_step(cfg)
    tok = fed(cfg, 1, "cuda")[0]
    pos = torch.full((B,), PROMPT, device="cuda")
    got, _ = step(params, cache, tok, pos)
    want, _ = forward(params, cfg, {"tokens": tok}, mode="decode",
                      cache=want_cache, pos=pos)
    assert torch.equal(got, want)
    assert (step.eager, step.replays, step.captures) == (1, 0, 0)


@pytest.mark.cuda
def test_new_cache_drops_the_graphs():
    """A new cache is a new key: its first call is eager, the graphs of the
    old one are dropped and the old cache is no longer held; reused from
    its start, a cache captures the buckets below those it holds."""
    card()
    cfg, params, cache, positions = card_model("plain")
    step = make_decode_step(cfg)
    toks = fed(cfg, 3, "cuda")
    step(params, cache, toks[0], 100)
    step(params, cache, toks[1], 101)
    old = weakref.ref(cache[0]["k"])
    held = step.captures
    cache = init_cache(cfg, B, cache[0]["k"].shape[2], device="cuda")
    step(params, cache, toks[2], 100)     # its top bucket alone
    gc.collect()
    assert old() is None
    assert (step.eager, step.replays, step.captures) == (2, 1, held + 1)
    step(params, cache, toks[0], 0)       # reused from its start
    assert (step.replays, step.captures) == (2, held + 2)
