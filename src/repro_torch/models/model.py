"""Model core for the port: config, init, caches and the forward pass.

A model is a pattern of block descriptors `(mixer, ffn)` repeated
`num_layers / len(pattern)` times; layer `r * P + i` (P the pattern's
length) is position `i` of repeat `r`, as in `repro`.  Ported patterns,
each in every mode `repro` runs it in:
  * any pattern whose positions are each ("attn" | "mamba", "dense" |
    "moe"): dense GQA `(("attn", "dense"),)`, full or sliding-window, with
    a SiLU, GELU or ReLU FFN (with a patch frontend, pixtral-12b, the
    caller's patch embeddings go before the tokens); GQA with the MoE FFN
    `(("attn", "moe"),)` (`moe.py`); either of those two with MLA
    (`attn_kind="mla"`, deepseek-v2-lite-16b) in place of GQA, the cache
    holding the latent and the rotary key, from which keys and values are
    expanded at each step; and jamba-1.5-large-398b's hybrid super-block,
    8 positions of Mamba (`ssm.py`) or attention, each with a dense or MoE
    FFN;
  * the encoder-decoder `(("attn_cross", "dense"),)`: a bidirectional
    encoder of dense blocks over the caller's source frame embeddings, and
    decoder blocks with cross-attention over its output;
  * mLSTM `(("mlstm", "none"),)`.
Modes: `train` (full-sequence logits, the offline train step),
`train_hidden` (the final-normed hiddens, for the fused loss), `prefill`
(the prompt's pass: last-token logits and the decode cache) and `decode`
(one token against the cache, the online-serving hot path).  Prefill
attention (self, cross and the encoder's) is `kernels.ops.flash_attention`,
decode attention (self and cross) `kernels.ops.decode_attention`, and the
Mamba prefill's scan `kernels.ops.ssm_scan`, which returns the state the
cache keeps; the train forward keeps `repro`'s attention (materialised, or
streamed over KV chunks past 4096**2 scores a head or with
`attn_force_chunked`) and the plain scan under autograd, and the mLSTM,
the MoE and Mamba's one-token decode run no kernel (`repro` ran them in
jnp).

`softcap` caps the scores (cap*tanh(s/cap)) exactly where `repro`'s does
(ROADMAP.md F8): GQA self-attention in train, in prefill (the flash
kernel) and in decode against a plain cache (the decode kernel, MHA too);
not on the ring cache's decode, in MLA, in cross-attention or in the
encoder.  With `remat` (the default) the train forward recomputes each
pattern repeat (its P layers, `repro`'s `jax.checkpoint(superblock)`) and
each encoder block in the backward (`torch.utils.checkpoint`): loss and
gradients are those without it.

Blocks are an `nn.ModuleList` of per-layer modules, run by a Python loop; the
cache keeps `repro`'s layout, a tuple over pattern positions of {"k", "v"}
(attention; {"k", "v", "xk", "xv"} with cross-attention; {"ckv", "kr"}
with MLA), {"h", "conv"} (Mamba) or {"C", "n", "m", "conv"} (mLSTM)
tensors with a leading `repeats` dimension.  A sliding-window model's
cache holds min(window, capacity) rows; at `window` rows it is `repro`'s
ring.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import kv_lengths
from repro_torch.obs.spans import span
from repro_torch.sharding.context import constrain

from . import layers as L
from . import moe as M
from . import ssm

DENSE_PATTERN = (("attn", "dense"),)
MOE_PATTERN = (("attn", "moe"),)
CROSS_PATTERN = (("attn_cross", "dense"),)
MLSTM_PATTERN = (("mlstm", "none"),)
# a position of the hybrid patterns (jamba's, and the one-position GQA ones)
HYBRID_MIXERS = ("attn", "mamba")
HYBRID_FFNS = ("dense", "moe")
MOE_IMPLS = ("grouped", "dense", "a2a")
ATTN_KINDS = ("gqa", "mla")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple = DENSE_PATTERN
    attn_kind: str = "gqa"            # gqa | mla
    window: int | None = None         # sliding window (None = full)
    rope_theta: float = 10000.0
    softcap: float | None = None      # scores cap*tanh(s/cap) (F8)
    kv_lora_rank: int = 0             # mla: the latent's width r
    rope_head_dim: int = 64           # mla: the rotary part's width dr
    ffn_act: str = "silu"
    # moe
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_renormalize: bool = True
    moe_impl: str = "grouped"         # grouped (production) | dense (oracle)
                                      # | a2a (expert-parallel, over a mesh)
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # ssm / mlstm
    ssm_d_inner: int = 0
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_dt_rank: int = 0
    ssm_chunk: int = 256              # data only: the port's scan is unchunked
    mlstm_proj_factor: int = 2
    # encoder (enc-dec archs)
    enc_layers: int = 0
    # modality frontend stubs: the caller passes the embeddings
    frontend: str = "none"            # none | audio | patch
    num_patches: int = 0              # vlm: image patches before the text
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "reference"      # data only: dead in `repro` (F3)
    attn_force_chunked: bool = False  # stream KV chunks even at short seqs
    fused_loss: bool = False          # stream the vocab dim in the loss
    remat: bool = True                # recompute each repeat in the backward
    vocab_pad_multiple: int = 256

    def __post_init__(self):
        hybrid = bool(self.pattern) and all(
            mixer in HYBRID_MIXERS and ffn in HYBRID_FFNS
            for mixer, ffn in self.pattern)
        gated = ((hybrid or self.pattern == CROSS_PATTERN)
                 and self.ffn_act in L.ACTS)
        if not (gated or self.pattern == MLSTM_PATTERN):
            raise NotImplementedError(
                f"{self.name}: pattern {self.pattern} is not ported: the port "
                f"runs patterns whose positions are each (one of "
                f"{HYBRID_MIXERS}, one of {HYBRID_FFNS}) and the cross "
                f"pattern {CROSS_PATTERN}, with an FFN gate in "
                f"{tuple(L.ACTS)}, and the mLSTM pattern {MLSTM_PATTERN}; "
                "see ROADMAP.md")
        if self.num_layers % len(self.pattern):
            raise ValueError(f"{self.name}: {self.num_layers} layers are not "
                             f"a whole number of the {len(self.pattern)}-"
                             "position pattern")
        if self.attn_kind not in ATTN_KINDS:
            raise NotImplementedError(
                f"{self.name}: attn_kind={self.attn_kind!r}; the port runs "
                f"{ATTN_KINDS}; see ROADMAP.md")
        if self.attn_kind == "mla" and (
                self.pattern not in (DENSE_PATTERN, MOE_PATTERN)
                or self.window is not None or self.enc_layers):
            raise NotImplementedError(
                f"{self.name}: MLA is ported with the patterns "
                f"{DENSE_PATTERN} and {MOE_PATTERN}, without a window, "
                "cross-attention or an encoder (no config of `repro` has "
                "them); see ROADMAP.md")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"{self.name}: moe_impl={self.moe_impl!r} is "
                             f"not one of {MOE_IMPLS}")

    @property
    def repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    def param_count(self) -> int:
        """Analytic parameter count, `repro`'s formula for the ported
        patterns (the profiling catalog's cost model reads it)."""
        d = self.d_model
        H, Hk, dh = self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * dh * (H + 2 * Hk) + H * dh * d
        if self.attn_kind == "mla":
            r, dr = self.kv_lora_rank, self.rope_head_dim
            self_attn = (d * H * (dh + dr) + d * (r + dr) + r * 2 * H * dh
                         + H * dh * d)
        else:
            self_attn = attn
        block = 0
        for mixer, ffn in self.pattern:
            block += d                                   # norm1
            if mixer in ("attn", "attn_cross"):
                block += self_attn
            if mixer == "attn_cross":
                block += attn + d                        # cross, norm_cross
            elif mixer == "mamba":
                di, N = self.ssm_d_inner, self.ssm_state_dim
                dtr, dc = self.ssm_dt_rank, self.ssm_conv_dim
                block += (d * 2 * di + dc * di + di * (dtr + 2 * N)
                          + dtr * di + di * N + di + di * d
                          + 2 * di)                      # conv_b, dt_bias
            elif mixer == "mlstm":
                dp = self.mlstm_proj_factor * d
                block += (d * 2 * dp + self.ssm_conv_dim * dp + 3 * dp * dp
                          + 2 * dp * self.num_heads + dp + dp * d
                          + dp + 2 * self.num_heads)     # conv_b, b_i, b_f
            if ffn == "dense":
                block += d + 3 * d * self.d_ff
            elif ffn == "moe":
                block += (d + d * self.num_experts
                          + self.num_experts * 3 * d * self.moe_d_ff
                          + 3 * d * self.moe_d_ff * self.num_shared_experts)
        p = 2 * self.padded_vocab * d + block * self.repeats + d
        if self.enc_layers:
            p += self.enc_layers * (2 * d + attn + 3 * d * self.d_ff) + d
        return p

    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: its top-k experts and the
        shared ones), `repro`'s formula."""
        moe = sum(ffn == "moe" for _, ffn in self.pattern)
        dead = (self.num_experts - self.top_k) * 3 * self.d_model \
            * self.moe_d_ff
        return self.param_count() - dead * moe * self.repeats


class Block(nn.Module):
    """A block of pattern position `desc`: a pre-norm mixer, self-attention
    (`attn`), Mamba or the mLSTM (`mixer`); for `attn_cross`, a pre-norm
    cross-attention over the encoder's output; then a pre-norm FFN, dense
    or the MoE, or none (the mLSTM's up-projection is its FFN)."""

    def __init__(self, cfg: ModelConfig, device,
                 desc: tuple = DENSE_PATTERN[0]):
        super().__init__()
        mixer, ffn = desc
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.dtype, device)
        if mixer == "mamba":
            self.mixer = ssm.Mamba(cfg, device)
        elif mixer == "mlstm":
            self.mixer = ssm.MLSTM(cfg, device)
        else:
            self.attn = (L.MLA(cfg, device) if cfg.attn_kind == "mla"
                         else L.GQA(cfg, device))
        if mixer == "attn_cross":
            self.norm_cross = L.RMSNorm(cfg.d_model, cfg.dtype, device)
            self.cross = L.CrossAttention(cfg, device)
        if ffn != "none":
            self.norm2 = L.RMSNorm(cfg.d_model, cfg.dtype, device)
            self.ffn = (M.MoE(cfg, device) if ffn == "moe" else
                        L.FFN(cfg.d_model, cfg.d_ff, cfg.dtype, device))


class Transformer(nn.Module):
    """Parameters (uninitialised) on `device`; names follow `repro`'s tree,
    with `blocks.<r * P + i>` in place of the stacked `blocks[i]`'s entry r
    and `enc_blocks.<layer>` in place of the stacked `enc_blocks`."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, V = cfg.d_model, cfg.padded_vocab
        self.embed = L.param((V, d), cfg.dtype, device)
        P = len(cfg.pattern)
        self.blocks = nn.ModuleList(Block(cfg, device, cfg.pattern[l % P])
                                    for l in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(d, cfg.dtype, device)
        self.lm_head = L.param((d, V), cfg.dtype, device)
        if cfg.enc_layers:
            self.enc_blocks = nn.ModuleList(Block(cfg, device)
                                            for _ in range(cfg.enc_layers))
            self.enc_final_norm = L.RMSNorm(d, cfg.dtype, device)


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random weights on the generator's device, drawn as `repro` draws them:
    embedding N(0, 0.02), projections truncated normal (+-2 std) with
    std 1/sqrt(fan_in) unless `repro` fixes the scale, norm scales 1.  A
    module with `init_rules(cfg)` (the mLSTM, Mamba) gives its own
    constants (gate biases, A_log, D, dt_bias) and fixed scales, by leaf
    within that module.  Drawn in fp32, stored in each parameter's type."""
    model = Transformer(cfg, generator.device)
    with torch.no_grad():
        for mname, mod in model.named_modules():
            rules = getattr(mod, "init_rules", None)
            consts, stds = rules(cfg) if rules else ({}, {})
            for leaf, p in mod.named_parameters(recurse=False):
                if leaf.endswith("scale"):
                    p.fill_(1.0)
                elif leaf in consts:
                    p.copy_(torch.as_tensor(consts[leaf]))
                elif not mname and leaf == "embed":
                    p.copy_(_draw(p.shape, p.device, generator, std=0.02))
                else:
                    p.copy_(_draw(p.shape, p.device, generator, stds.get(
                        leaf, 1.0 / math.sqrt(p.shape[0])), truncated=True))
    return model


def _draw(shape, device, generator, std: float, truncated: bool = False):
    """fp32 N(0, std) draws, truncated at +-2 std if asked.  The caller
    copies them into the parameter in one statement, so one parameter's
    fp32 scratch at most is alive at a time (jamba's expert stacks are 12
    GiB each)."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if truncated:
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)
    return w.normal_(0.0, std, generator=generator)


def init_cache(cfg: ModelConfig, batch: int, kv_capacity: int,
               src_len: int = 0, device=None) -> tuple:
    """Decode cache, a tuple over pattern positions, each leaf with a leading
    `repeats` dimension.  Attention: {"k", "v"}, each (repeats, batch, cap,
    Hk, head_dim) zeros in cfg.dtype, where cap is kv_capacity, or
    min(window, kv_capacity) for a sliding window (the ring's bound); an
    `attn_cross` block adds {"xk", "xv"} of src_len rows (the encoder's
    keys and values, which prefill writes).  MLA: {"ckv" (repeats, batch,
    cap, kv_lora_rank), "kr" (repeats, batch, cap, 1, rope_head_dim)}, the
    latent and the rotated key.  Mamba: {"h" (repeats, batch, di, N) fp32,
    "conv" (repeats, batch, dc-1, di) in cfg.dtype}, zeros, the shapes of
    `ssm.mamba_state_init`.  mLSTM: {"C", "n", "m"} in fp32 (m at -60) and
    "conv" in cfg.dtype, the shapes of `ssm.mlstm_state_init`.  kv_capacity
    applies to attention alone."""
    dev = resolve_device(device)
    R = cfg.repeats
    cap = (kv_capacity if cfg.window is None
           else min(cfg.window, kv_capacity))
    def zeros(rows: int, *row) -> torch.Tensor:
        row = row or (cfg.num_kv_heads, cfg.head_dim)
        return torch.zeros((R, batch, rows, *row), dtype=cfg.dtype,
                           device=dev)

    def repeated(state: dict) -> dict:
        return {k: v.expand(R, *v.shape).clone() for k, v in state.items()}

    caches = []
    for mixer, _ in cfg.pattern:
        if mixer == "mamba":
            c = repeated(ssm.mamba_state_init(batch, cfg, dev))
        elif mixer == "mlstm":
            st = ssm.mlstm_state_init(batch, cfg, dev)
            c = repeated(dict(zip("Cnm", st["carry"]), conv=st["conv"]))
        elif cfg.attn_kind == "mla":
            c = {"ckv": zeros(cap, cfg.kv_lora_rank),
                 "kr": zeros(cap, 1, cfg.rope_head_dim)}
        else:
            c = {"k": zeros(cap), "v": zeros(cap)}
        if mixer == "attn_cross":
            c.update(xk=zeros(src_len), xv=zeros(src_len))
        caches.append(c)
    return tuple(caches)


def _scale(cfg: ModelConfig) -> torch.Tensor:
    # sqrt(d_model) rounded to the model dtype first, as JAX's weak float is
    return torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)


def _embed(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor):
    x = _lookup(params.embed, tokens)
    return constrain(x, *("dp",) + (None,) * (x.ndim - 1)) * _scale(cfg)


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens].  Over a mesh that splits the vocab (`embed`'s
    ("tp", "fsdp")), GSPMD's lookup: the row width's FSDP split is
    gathered, each rank looks up the tokens its vocab rows hold (zero for
    the rest) for its batch rows, and the ranks of the vocab split sum
    (a Partial placement).  DTensor's own rule for it moves the tokens
    into a masked partial that its backward cannot carry."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor) or Shard(0) not in table.placements:
        return table[tokens]
    from repro_torch.sharding.context import from_shard, resolve, to_layout
    mesh = table.device_mesh
    pl = [Replicate() if p == Shard(1) else p for p in table.placements]
    t_spec = resolve(mesh, ("dp",) + (None,) * (tokens.ndim - 1),
                     tokens.shape)
    tok = to_layout(tokens, mesh, t_spec)
    rows = list(tok.placements)
    grad_pl = [Partial() if r == Shard(0) else p
               for r, p in zip(rows, pl)]
    w = table.redistribute(mesh, pl).to_local(grad_placements=grad_pl)
    v0 = 0
    for i, p in enumerate(pl):
        if p == Shard(0):
            v0 = v0 * mesh.shape[i] + mesh.get_local_rank(i)
    v0 *= w.shape[0]
    tl = tok.to_local()
    mine = (tl >= v0) & (tl < v0 + w.shape[0])
    x = w[torch.where(mine, tl - v0, 0)] * mine[..., None].to(w.dtype)
    out_pl = [Partial() if p == Shard(0) else r for r, p in zip(rows, pl)]
    return from_shard(x, mesh, out_pl, tuple(tokens.shape) + (table.shape[1],))


def _embed_inputs(params: Transformer, cfg: ModelConfig, batch: dict):
    """`repro`'s `_embed_inputs`: for a patch frontend, the patch embeddings
    (B, n_p, d), cast to the model type, before the token embeddings, and
    the whole sequence scaled by sqrt(d_model), patches included."""
    dev = params.embed.device
    x = _embed(params, cfg, torch.as_tensor(batch["tokens"],
                                            device=dev).long())
    if cfg.frontend == "patch" and "patch_embeds" in batch:
        patches = torch.as_tensor(batch["patch_embeds"], device=dev)
        x = torch.cat([patches.to(cfg.dtype) * _scale(cfg), x], dim=1)
    return constrain(x, "dp", None, None)


def _ffn(blk: Block, cfg: ModelConfig, x: torch.Tensor):
    """The block's pre-norm FFN: (x + ffn(norm2(x)), the MoE's aux loss or
    0.0)."""
    h = L.rmsnorm(blk.norm2, x)
    if isinstance(blk.ffn, M.MoE):
        o, aux = M.moe_ffn(blk.ffn, h, cfg)
        return x + o, aux
    return x + L.ffn(blk.ffn, h, cfg.ffn_act), 0.0


def forward(params: Transformer, cfg: ModelConfig, batch: dict, *,
            mode: str = "decode", cache: tuple | None = None, pos=None):
    """decode: batch={"tokens": (B, 1)}, cache, pos (int or (B,); the mLSTM
    and a pattern of Mamba alone ignore it) -> (logits (B, Vpad), cache).
    prefill: batch={"tokens": (B, S)} (with "patch_embeds" (B, n_p, d) for
    a patch frontend, "src_embeds" (B, S_src, d) for an encoder) ->
    (logits of the last position (B, Vpad), a new cache of n_p + S rows (or
    the window's, ring-aligned; the cross keys and values of S_src rows),
    aux).
    train: the same batch -> (logits (B, n_p + S, Vpad), aux).
    train_hidden: the same batch -> (final-normed hiddens (B, n_p + S, d),
    aux).
    aux is the sum of the layers' MoE aux losses, an fp32 scalar (zero
    without MoE).

    In decode the cache is updated in place: `repro` wrote a new cache
    functionally, which at full width would copy every layer's cache on
    every step.  The returned cache is the object passed in."""
    if mode in ("train", "train_hidden", "prefill"):
        return _forward_blocks(params, cfg, batch, mode)
    if mode != "decode" or cache is None:
        raise NotImplementedError(
            f"mode={mode!r}: the port runs train, train_hidden, prefill, "
            "and decode against a cache; see ROADMAP.md")
    return _forward_decode(params, cfg, batch, cache, pos)


class _AttnStep(NamedTuple):
    """What a decode step's attention layers share."""
    slot: torch.Tensor          # (B,) the cache row each sequence writes
    lens: torch.Tensor          # (B,) int32 rows each sequence's query reads
    src_lens: torch.Tensor      # (B,) int32 rows of the cross cache
    live: int                   # rows the caches are cut to: the longest
                                # lens or more
    rope: tuple                 # rotary angles at each sequence's position
    rows: torch.Tensor          # arange(B)
    ring: bool                  # the sliding window's ring cache


def decode_positions(cfg: ModelConfig, c: dict, pos, B: int
                     ) -> tuple[torch.Tensor, int]:
    """The host's half of a decode step's positions, from `pos` and an
    attention position's cache `c` (every attention position has the same
    rows): ((3, B) int32 on the host: the positions, the rows each
    sequence's query reads and the cross attention's source rows; the
    longest of those rows)."""
    mla = cfg.attn_kind == "mla"
    cap = c["ckv" if mla else "k"].shape[2]
    # `repro`'s ring: a sliding-window cache of exactly `window` rows, written
    # at slot pos % window.  Its valid slots are the first min(pos + 1, W)
    # (the softmax does not depend on their order), so the kernel reads them
    # with kv_len = min(pos + 1, W); rotary angles keep the absolute position.
    # kv_len is checked against the capacity once, on the host; a pos on the
    # card is copied there first (one wait for the card), so that a position
    # past the cache raises instead of being clamped by the kernel
    host_pos = torch.as_tensor(pos).cpu().long().reshape(-1).expand(B)
    host_lens = host_pos + 1
    if _is_ring(cfg, cap):
        host_lens = torch.clamp(host_lens, max=cap)
    host_lens = kv_lengths(host_lens, B, cap, torch.device("cpu"))
    # the positions, the lengths and the cross attention's source rows
    # (every row of the cross cache; 1, unread, without one) side by side,
    # for one copy to the card
    src_len = c["xk"].shape[2] if "xk" in c else 1
    if src_len < 1:
        raise ValueError("the cross cache holds no source rows: size it with "
                         "init_cache(..., src_len=...) and fill it by prefill")
    pos_lens = torch.stack([host_pos.int(), host_lens,
                            torch.full((B,), src_len, dtype=torch.int32)])
    return pos_lens, int(host_lens.max())


def _is_ring(cfg: ModelConfig, cap: int) -> bool:
    return cfg.window is not None and cap == cfg.window


def _attn_step(cfg: ModelConfig, c: dict, pos_lens: torch.Tensor, live: int,
               dev) -> _AttnStep:
    """Slots, lengths and rotary angles from `decode_positions`'s
    `pos_lens` on the card; the caches are read up to `live` rows."""
    mla = cfg.attn_kind == "mla"
    cap = c["ckv" if mla else "k"].shape[2]
    ring = _is_ring(cfg, cap)
    pos_b, lens, src_lens = pos_lens[0].long(), pos_lens[1], pos_lens[2]
    # MLA rotates its dr-wide part alone
    rope = L.rope_table(pos_b[:, None],
                        cfg.rope_head_dim if mla else cfg.head_dim,
                        cfg.rope_theta)
    # attention reads the caches cut to `live` rows (a view): no row past
    # it is visible, and the kernel sizes its split from it
    return _AttnStep(pos_b % cap if ring else pos_b, lens, src_lens, live,
                     rope, torch.arange(pos_lens.shape[1], device=dev), ring)


def _forward_decode(params: Transformer, cfg: ModelConfig, batch: dict,
                    cache: tuple, pos):
    """Decode: layer r * P + i reads and writes repeat r of cache[i]; a
    recurrent layer's state (Mamba's h and conv window, the mLSTM's C, n,
    m and conv window) is overwritten with the step's, an attention
    layer's row at its slot."""
    dev = params.embed.device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    attn = _attn_caches(cfg, cache)
    with span("decode.prepare"):
        at = None
        if attn:
            pos_lens, live = decode_positions(cfg, attn[0], pos,
                                              tokens.shape[0])
            at = _attn_step(cfg, attn[0], pos_lens.to(dev), live, dev)
    return _decode_layers(params, cfg, tokens, cache, at)


def decode_on_card(params: Transformer, cfg: ModelConfig,
                   tokens: torch.Tensor, cache: tuple,
                   pos_lens: torch.Tensor, live: int):
    """The decode step with `decode_positions`'s positions already on the
    card (`pos_lens`, (3, B) int32) and its caches read up to `live` rows,
    at least the longest sequence's: no call waits for the card or reads
    the host, so a CUDA graph can capture it.  tokens: (B, 1) int64 on the
    card.  -> (logits (B, Vpad), cache), the cache updated in place."""
    with span("decode.prepare"):
        at = _attn_step(cfg, _attn_caches(cfg, cache)[0], pos_lens, live,
                        params.embed.device)
    return _decode_layers(params, cfg, tokens, cache, at)


def _attn_caches(cfg: ModelConfig, cache: tuple) -> list:
    return [c for c, (mixer, _) in zip(cache, cfg.pattern)
            if mixer.startswith("attn")]


def _decode_layers(params: Transformer, cfg: ModelConfig,
                   tokens: torch.Tensor, cache: tuple, at: _AttnStep | None):
    """The decode step's layers and head from the step's positions `at`."""
    B = tokens.shape[0]
    H, dh, P = cfg.num_heads, cfg.head_dim, len(cfg.pattern)
    mla = cfg.attn_kind == "mla"
    mla_decode = L.pad_v(ops.decode_attention)

    x = _embed(params, cfg, tokens)
    for l, blk in enumerate(params.blocks):
        with span("decode.layer"):
            i, r = l % P, l // P
            c = cache[i]
            h = L.rmsnorm(blk.norm1, x)
            mixer, ffn = cfg.pattern[i]
            if mixer == "mamba":
                o, st = ssm.mamba_decode_step(blk.mixer, h, {
                    "h": c["h"][r], "conv": c["conv"][r]}, cfg)
                for name, new in st.items():
                    c[name][r].copy_(new)
                x = x + o
            elif mixer == "mlstm":
                o, st = ssm.mlstm_decode_step(blk.mixer, h, {
                    "carry": (c["C"][r], c["n"][r], c["m"][r]),
                    "conv": c["conv"][r]}, cfg)
                for name, new in zip(("C", "n", "m", "conv"),
                                     (*st["carry"], st["conv"])):
                    c[name][r].copy_(new)
                x = x + o
            elif mla:
                ckv, kr = L.mla_latent(blk.attn, h, cfg, at.rope)
                L.write_rows(c["ckv"][r], at.rows, at.slot, ckv[:, 0])
                L.write_rows(c["kr"][r], at.rows, at.slot, kr[:, 0])
                # keys and values expanded from the `live` rows the kernel
                # reads only: `repro` expanded the whole cache, whose rows
                # past kv_len are masked, to the same result
                ckv, kr = L.live_rows(at.live, c["ckv"][r], c["kr"][r])
                x = x + L.mla_attend(blk.attn, h, ckv, kr, cfg, at.rope,
                                     attend=mla_decode, kv_len=at.lens)
            else:
                q, k, v = L.gqa_project_qkv(blk.attn, h, cfg, at.rope)
                kc, vc = c["k"][r], c["v"][r]
                L.write_rows(kc, at.rows, at.slot, k[:, 0])
                L.write_rows(vc, at.rows, at.slot, v[:, 0])
                # every Sq == 1 attention takes the decode kernel, MHA
                # included (`repro` sent MHA down its dense path: the same
                # function); `repro` caps the scores on a plain cache, never
                # on the ring
                o = ops.decode_attention(q, *L.live_rows(at.live, kc, vc),
                                         at.lens,
                                         None if at.ring else cfg.softcap)
                x = x + L.row_parallel(o.reshape(B, 1, H * dh),
                                       blk.attn.w_o)
            if "xk" in c:
                # the encoder's keys and values, every source row visible
                h = L.rmsnorm(blk.norm_cross, x)
                q = L.cross_project_q(blk.cross, h, cfg)
                o = ops.decode_attention(q, c["xk"][r], c["xv"][r],
                                         at.src_lens)
                x = x + L.row_parallel(o.reshape(B, 1, H * dh),
                                       blk.cross.w_o)
            if ffn != "none":
                x, _ = _ffn(blk, cfg, x)
            x = constrain(x, "dp", None, None)
    with span("decode.head"):
        x = L.rmsnorm(params.final_norm, x)
        return x[:, 0] @ params.lm_head, cache


def _encoder_forward(params: Transformer, cfg: ModelConfig, batch: dict,
                     attend, remat: bool = False):
    """The bidirectional encoder over the stub frame embeddings
    `batch["src_embeds"]` (B, S_src, d), with rotary at arange(S_src);
    `attend` is the train or the prefill attention, `remat` recomputes
    each block in the backward.  A batch without them raises KeyError, as
    `repro`'s forward does (ROADMAP.md F6)."""
    if "src_embeds" not in batch:
        raise KeyError(f"src_embeds: {cfg.name} encodes the batch's source "
                       "frame embeddings, and `repro` raises KeyError here "
                       "too (ROADMAP.md F6)")
    dev = params.embed.device
    x = torch.as_tensor(batch["src_embeds"], device=dev).to(cfg.dtype) \
        * _scale(cfg)
    B, S_src, _ = x.shape
    rope = L.rope_table(torch.arange(S_src, device=dev)[None], cfg.head_dim,
                        cfg.rope_theta)

    def block(blk: Block, x: torch.Tensor) -> torch.Tensor:
        h = L.rmsnorm(blk.norm1, x)
        q, k, v = L.gqa_project_qkv(blk.attn, h, cfg, rope)
        o = attend(q, k, v, causal=False)
        x = x + L.row_parallel(
            o.reshape(B, S_src, cfg.num_heads * cfg.head_dim), blk.attn.w_o)
        return _ffn(blk, cfg, x)[0]

    for blk in params.enc_blocks:
        x = L.recompute(block, blk, x) if remat else block(blk, x)
    return L.rmsnorm(params.enc_final_norm, x)


def _forward_blocks(params: Transformer, cfg: ModelConfig, batch: dict,
                    mode: str):
    """Train, train_hidden and prefill, every pattern.  Attention: train
    runs `repro`'s `layers.attention` under autograd (materialised, or
    streamed over KV chunks), prefill the port's flash kernel on the card,
    where `repro` ran its own attention (F3's documented divergence, held at
    the reference's tolerances).  The GQA self-attention's scores are
    capped by `cfg.softcap` in both; MLA, cross-attention and the encoder
    are not (F8).  q and k come out of `apply_rope` and v out of a reshape,
    all contiguous, so the bf16 kernel's 16-byte row check holds at every
    head width the configs have (d 120: 240-byte rows) and no copy is made.
    Cross-attention sees every source row (non-causal, Sq != Skv) and its
    keys and values have no rotary embedding.  Mamba: `ssm.mamba_mixer`
    (the scan kernel on the card outside autograd); its prefill cache is
    the scan's last state and the conv window, the last dc-1 rows of the
    pre-conv input, projected again from those rows of the block's input
    alone (each row's projection is its own), as `repro` takes them.  The
    mLSTM: the chunked `ssm.mlstm_mixer`; its cache is the carry and the
    conv window, taken as Mamba's.  With `cfg.remat` a train forward runs
    each pattern repeat (and each encoder block) under `layers.recompute`."""
    prefill = mode == "prefill"
    remat = cfg.remat and not prefill
    if prefill:
        attend = ops.flash_attention
        self_attend = functools.partial(attend, softcap=cfg.softcap)
        # the kernels take one width for q, k and v: MLA's v is padded
        mla_attend = L.pad_v(attend)
    else:
        attend = L.attention
        self_attend = functools.partial(attend, softcap=cfg.softcap,
                                        force_chunked=cfg.attn_force_chunked)
        mla_attend = functools.partial(attend,
                                       force_chunked=cfg.attn_force_chunked)
    enc = (_encoder_forward(params, cfg, batch, attend, remat)
           if cfg.enc_layers else None)
    x = _embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    H, dh, W, P = cfg.num_heads, cfg.head_dim, cfg.window, len(cfg.pattern)
    mla = cfg.attn_kind == "mla"
    # MLA rotates its dr-wide part alone
    rope = L.rope_table(torch.arange(S, device=x.device)[None],
                        cfg.rope_head_dim if mla else dh, cfg.rope_theta)
    tail = cfg.ssm_conv_dim - 1

    def layer(blk: Block, i: int, x: torch.Tensor, aux: torch.Tensor):
        """Layer at pattern position i: (x, its prefill cache leaves, aux)."""
        mixer, ffn = cfg.pattern[i]
        new = {}
        h = L.rmsnorm(blk.norm1, x)
        if mixer == "mamba":
            o, h_last = ssm.mamba_mixer(blk.mixer, h, cfg)
            if prefill:
                di = cfg.ssm_d_inner
                new = {"h": h_last,
                       "conv": h[:, -tail:] @ blk.mixer.in_proj[:, :di]}
            x = x + o
        elif mixer == "mlstm":
            o, carry = ssm.mlstm_mixer(blk.mixer, h, cfg)
            if prefill:
                dp = cfg.mlstm_proj_factor * cfg.d_model
                new = dict(zip("Cnm", carry),
                           conv=h[:, -tail:] @ blk.mixer.up_proj[:, :dp])
            x = x + o
        elif mla:
            ckv, kr = L.mla_latent(blk.attn, h, cfg, rope)
            x = x + L.mla_attend(blk.attn, h, ckv, kr, cfg, rope,
                                 attend=mla_attend, causal=True)
            new = {"ckv": ckv, "kr": kr}
        else:
            q, k, v = L.gqa_project_qkv(blk.attn, h, cfg, rope)
            o = self_attend(q, k, v, causal=True, window=W)
            if prefill and W is not None and S > W:
                # the last W rows, rolled so that position p sits at slot
                # p % W (`repro`'s ring-aligned prefill cache)
                k, v = (torch.roll(t[:, -W:], S % W, dims=1)
                        for t in (k, v))
            new = {"k": k, "v": v}
            x = x + L.row_parallel(o.reshape(B, S, H * dh), blk.attn.w_o)
        if enc is not None:
            h = L.rmsnorm(blk.norm_cross, x)
            q = L.cross_project_q(blk.cross, h, cfg)
            xk, xv = L.cross_project_kv(blk.cross, enc, cfg)
            o = attend(q, xk, xv, causal=False)
            new.update(xk=xk, xv=xv)
            x = x + L.row_parallel(o.reshape(B, S, H * dh), blk.cross.w_o)
        if ffn != "none":
            x, a = _ffn(blk, cfg, x)
            aux = aux + a
        return constrain(x, "dp", None, None), new, aux

    def repeat(x: torch.Tensor, aux: torch.Tensor, r: int):
        """Pattern repeat r (layers r * P .. r * P + P - 1) in train."""
        for i in range(P):
            x, _, aux = layer(params.blocks[r * P + i], i, x, aux)
        return x, aux

    aux = torch.zeros((), device=x.device)
    if not prefill:
        for r in range(cfg.repeats):
            x, aux = (L.recompute(repeat, x, aux, r) if remat
                      else repeat(x, aux, r))
        x = L.rmsnorm(params.final_norm, x)
        if mode == "train_hidden":
            return x, aux
        return x @ params.lm_head, aux
    # the prefill cache: for each pattern position, its leaves by name, one
    # tensor a repeat
    leaves = [{} for _ in cfg.pattern]
    for l, blk in enumerate(params.blocks):
        x, new, aux = layer(blk, l % P, x, aux)
        for name, t in new.items():
            leaves[l % P].setdefault(name, []).append(t)
    cache = tuple({name: torch.stack(ts) for name, ts in named.items()}
                  for named in leaves)
    return _last_logits(params, x), cache, aux


def _last_logits(params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """lm_head on the last position only (the norm is per position)."""
    return (L.rmsnorm(params.final_norm, x[:, -1:]) @ params.lm_head)[:, 0]
