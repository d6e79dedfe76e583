"""The decode step replayed from CUDA graphs.

A decode step of h2o-danube-1.8b issues some 1,400 small kernels, whose
launches take the host 8-10 times the card's own time; replayed from a
CUDA graph, the step is launched at once and the card runs it at its own
pace.  Nothing changes in what the step computes: the graph holds the
same layers and the same hand-written kernels as the eager step.

Where it engages, decided from each call:
  * every position of `cfg.pattern` is GQA attention (ring or plain
    cache) with a dense FFN, the types a card test has captured
    (`CAPTURABLE`); MoE, MLA, Mamba, the mLSTM and cross attention run
    eagerly;
  * the params and the cache are plain CUDA tensors on one card (not
    DTensors, not on the meta device), and no capture is open on the
    stream;
  * `pos` lies on the host (an int or a CPU tensor): one on the card would
    be read back for the capacity check, a wait for the card;
  * the tokens are a (B, 1) tensor, on the host or on the params' card.
Every other call is `forward(mode="decode")`, counted in `eager`.

Graphs are keyed by the params, the tokens' shape and the identity, shape
and dtype of the cache's leaves; within a key by the live bucket
(`live_bucket`), so that the kernel's split plan reads at most a bucket's
rows past the live ones.  The first call of a key runs eagerly (the
warm-up: the kernel's library, its occupancy plan, cuBLAS's handles) and
then captures every bucket from its own to the capacity, in one memory
pool; a later call captures only a bucket below those (a cache reused from
its start).  A new key drops the graphs.  The step holds the params, the
cache and its static buffers as long as its graphs may read them.

A replay: the host computes the positions (`model.decode_positions`, which
raises for a position past a plain cache as the eager step does), copies
them through pinned memory, and the tokens, into the graph's static
buffers on the stream, replays the bucket's graph and returns a copy of
its logits, so that the next replay does not overwrite logits a caller
kept.  The decode kernel's `launches` counter adds each graph's captured
launches on each replay (no other kernel runs in a capturable step); the
spans inside the step (`decode.prepare`, `decode.layer`,
`decode.attention`, `decode.head`) are recorded at capture only.
"""
from __future__ import annotations

import numbers

import torch

from repro_torch.kernels import decode_attention
from repro_torch.obs.spans import span

from .model import ModelConfig, decode_on_card, decode_positions, forward

BUCKETS = 8                         # graphs a cache holds at most
CAPTURABLE = (("attn", "dense"),)   # pattern positions a card test captured


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bucket_rows(cap: int, tile_rows: int) -> int:
    return _cdiv(_cdiv(cap, BUCKETS), tile_rows) * tile_rows


def live_buckets(cap: int, tile_rows: int) -> tuple[int, ...]:
    """The live buckets of a cache of `cap` rows: multiples of cap / 8
    rounded up to the kernel's `tile_rows`, the last equal to cap."""
    step = _bucket_rows(cap, tile_rows)
    return tuple(min(b, cap) for b in range(step, cap + step, step))


def live_bucket(live: int, cap: int, tile_rows: int) -> int:
    """The bucket of `live_buckets` that holds `live` in (lo, hi]."""
    step = _bucket_rows(cap, tile_rows)
    return min(_cdiv(live, step) * step, cap)


class DecodeStep:
    """decode_step(params, cache, tokens (B, 1), pos) -> (logits (B, Vpad),
    cache): one token for the whole batch against the standing cache, which
    is updated in place; replayed from CUDA graphs where it engages (see
    the module's docstring).  Counts its steps in `replays` and `eager`,
    and its graphs in `captures`."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.replays = 0
        self.captures = 0
        self.eager = 0
        self._capturable = cfg.attn_kind == "gqa" and all(
            p in CAPTURABLE for p in cfg.pattern)
        self._drop()

    def _drop(self) -> None:
        self._key = None
        self._graphs = {}       # live bucket -> (graph, logits, launches)
        self._held = None       # what the graphs read: params, cache
        self._tokens = self._pos_lens = self._pool = self._stream = None
        self._cap = self._tile = 0          # the cache's rows, the tile's

    @torch.no_grad()
    def __call__(self, params, cache, tokens, pos):
        with span("decode.step"):
            key = self._key_of(params, cache, tokens, pos)
            if key is None:
                self.eager += 1
                return forward(params, self.cfg, {"tokens": tokens},
                               mode="decode", cache=cache, pos=pos)
            if key != self._key:
                return self._warm_up(key, params, cache, tokens, pos)
            return self._replay(cache, tokens, pos)

    def _key_of(self, params, cache, tokens, pos):
        """The call's graph key, or None where the step runs eagerly."""
        if not self._capturable or not isinstance(tokens, torch.Tensor) \
                or tokens.dim() != 2 or tokens.shape[1] != 1:
            return None
        if isinstance(pos, torch.Tensor):
            if pos.device.type != "cpu":
                return None
        elif not isinstance(pos, numbers.Integral):
            return None
        leaves = [t for c in cache for t in c.values()]
        key = (id(params), tuple(tokens.shape),
               tuple((id(t), t.shape, t.dtype) for t in leaves))
        if key != self._key:
            from torch.distributed.tensor import DTensor
            dev = params.embed.device
            if dev.type != "cuda" or tokens.device not in (
                    dev, torch.device("cpu")) or any(
                    isinstance(t, DTensor) or t.device != dev
                    for t in [params.embed, *leaves]):
                return None
        if torch.cuda.is_current_stream_capturing():
            return None
        return key

    def _warm_up(self, key, params, cache, tokens, pos):
        """The key's first call: eager, then the captures."""
        self._drop()
        self.eager += 1
        out = forward(params, self.cfg, {"tokens": tokens}, mode="decode",
                      cache=cache, pos=pos)
        dev, B = params.embed.device, tokens.shape[0]
        k = cache[0]["k"]
        self._key, self._held = key, (params, cache)
        self._cap = k.shape[2]
        self._tile = decode_attention.tile_rows(
            dev, k.dtype, self.cfg.num_heads, self.cfg.num_kv_heads,
            self.cfg.head_dim)
        self._tokens = torch.zeros((B, 1), dtype=torch.long, device=dev)
        self._pos_lens = torch.zeros((3, B), dtype=torch.int32, device=dev)
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(dev)
        _, live = decode_positions(self.cfg, cache[0], pos, B)
        self._capture_from(live)
        return out

    def _capture_from(self, live: int) -> None:
        """Captures every bucket from live's to the lowest one held (or to
        the capacity)."""
        lo = live_bucket(live, self._cap, self._tile)
        for b in live_buckets(self._cap, self._tile):
            if b >= lo and b not in self._graphs:
                self._capture(b)

    def _capture(self, bucket: int) -> None:
        params, cache = self._held
        graph = torch.cuda.CUDAGraph()
        before = decode_attention.launches
        stream = self._stream
        current = torch.cuda.current_stream(stream.device)
        with span("decode.capture"):
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self._pool)
                try:
                    logits, _ = decode_on_card(params, self.cfg,
                                               self._tokens, cache,
                                               self._pos_lens, bucket)
                finally:
                    graph.capture_end()
            current.wait_stream(stream)
        # a capture launches nothing: its launches count at each replay
        launched = decode_attention.launches - before
        decode_attention.launches = before
        self._graphs[bucket] = (graph, logits, launched)
        self.captures += 1

    def _replay(self, cache, tokens, pos):
        pos_lens, live = decode_positions(self.cfg, cache[0], pos,
                                          tokens.shape[0])
        bucket = live_bucket(live, self._cap, self._tile)
        if bucket not in self._graphs:
            self._capture_from(live)
        graph, logits, launched = self._graphs[bucket]
        # stream-ordered writes: the previous replay has read its inputs
        # before these copies run, and the pinned sources are not reused
        # until they have
        self._pos_lens.copy_(pos_lens.pin_memory(), non_blocking=True)
        self._tokens.copy_(tokens if tokens.is_cuda else tokens.pin_memory(),
                           non_blocking=True)
        with span("decode.replay"):
            graph.replay()
        decode_attention.launches += launched
        self.replays += 1
        return logits.clone(), cache
