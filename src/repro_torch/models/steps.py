"""Step functions: the decode step MuxFlow protects (the online workload),
the prefill and greedy generation around it, and the train and eval steps
of the offline workload."""
from __future__ import annotations

import math

import torch

from repro_torch.obs.spans import span
from repro_torch.sharding.context import constrain

from . import layers as L
from .decode_graph import DecodeStep
from .model import ModelConfig, forward, init_cache


def make_prefill(cfg: ModelConfig):
    """prefill(params, batch) -> (next-token logits (B, Vpad), cache)."""

    @torch.no_grad()
    def prefill(params, batch):
        logits, cache, _aux = forward(params, cfg, batch, mode="prefill")
        return logits, cache

    return prefill


def make_decode_step(cfg: ModelConfig) -> DecodeStep:
    """decode_step(params, cache, tokens (B,1), pos) -> (logits (B,Vpad),
    cache): one token for the whole batch against the standing cache, which
    is updated in place; on the card replayed from CUDA graphs where the
    call allows (`decode_graph`)."""
    return DecodeStep(cfg)


def _num_patches(cfg: ModelConfig, batch: dict) -> int:
    """Positions the patch frontend puts before the tokens."""
    if cfg.frontend == "patch" and "patch_embeds" in batch:
        return batch["patch_embeds"].shape[1]
    return 0


def greedy_generate(cfg: ModelConfig, params, batch: dict,
                    steps: int) -> torch.Tensor:
    """Prefill, then `steps` greedy decode steps: (B, steps + 1) token ids on
    the params' device, the first from the prefill's logits.  The decode
    cache has room for S0 + steps rows, S0 the prompt's positions (its
    patches and tokens), a cross cache of the source's rows, and starts from
    the prefill's; the argmax runs over the first vocab_size columns on the
    device."""
    logits, cache = make_prefill(cfg)(params, batch)
    decode = make_decode_step(cfg)
    B, S_tok = batch["tokens"].shape
    S0 = S_tok + _num_patches(cfg, batch)
    src_len = batch["src_embeds"].shape[1] if "src_embeds" in batch else 0
    cache = _copy_prefix_cache(
        cache, init_cache(cfg, B, S0 + steps, src_len=src_len,
                          device=logits.device))
    toks = [logits[:, :cfg.vocab_size].argmax(-1)]
    for i in range(steps):
        logits, cache = decode(params, cache, toks[-1][:, None], S0 + i)
        toks.append(logits[:, :cfg.vocab_size].argmax(-1))
    return torch.stack(toks, dim=1)


def _copy_prefix_cache(src: tuple, dst: tuple) -> tuple:
    """The prefill cache `src` in the decode cache `dst`: the attention
    leaves (k, v, the cross keys and values xk, xv, and MLA's latent ckv
    and rotary key kr) written into dst's first rows (in place), a
    recurrent state (the mLSTM's C, n, m and conv, Mamba's h and conv)
    taken whole.  Over a mesh each rank writes its own rows of a DTensor
    cache (`layers.write_prefix`)."""
    out = []
    for s, d in zip(src, dst):
        d = dict(d)
        for name, v in s.items():
            if name in ("k", "v", "xk", "xv", "ckv", "kr"):
                L.write_prefix(d[name], v)
            else:
                d[name] = v
        out.append(d)
    return tuple(out)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  vocab_size: int, mask: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Mean next-token cross-entropy.  logits: (B,S,Vpad); targets: (B,S).
    Padded-vocab columns are excluded from the partition function."""
    Vpad = logits.shape[-1]
    lf = logits.float()
    if Vpad > vocab_size:
        cols = torch.arange(Vpad, device=lf.device)
        lf = lf + torch.where(cols < vocab_size, 0.0, -1e9)
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(lf, DTensor) and Shard(lf.ndim - 1) in lf.placements:
        lse, gold = _split_vocab_terms(lf, targets)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _split_vocab_terms(lf, targets):
    """(log-sum-exp, the target's logit) of fp32 logits lf (B, S, Vpad)
    whose vocab is split over a mesh, as reductions over the split dim
    (partial sums across its shards, as GSPMD computes them): DTensor's
    logsumexp and gather need the vocab whole, and the gather's backward
    allocates the global shape.  The same values as the one-device
    path's: the max is detached (its gradient cancels), and a sum of one
    logit and zeros is that logit."""
    m = lf.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    cols = torch.arange(lf.shape[-1], device=lf.device)
    hit = cols == targets[..., None].long()
    gold = torch.where(hit, lf, 0.0).sum(-1)
    return constrain(lse, "dp", None), constrain(gold, "dp", None)


def chunked_cross_entropy(x: torch.Tensor, lm_head: torch.Tensor,
                          targets: torch.Tensor, vocab_size: int,
                          mask: torch.Tensor, chunk: int = 8192
                          ) -> torch.Tensor:
    """`repro`'s fused loss: the masked mean next-token cross-entropy of
    the hiddens x (B, S, d) (post-norm) under lm_head (d, Vpad), never
    materialising the (B, S, Vpad) logits: a streaming log-sum-exp over
    vocab chunks of `chunk` columns (gcd(Vpad, chunk) where it does not
    divide), each chunk's logits recomputed in the backward
    (`layers.recompute`).  Each chunk's logits are x @ w in the model type,
    then fp32, as the unfused loss's.  x enters the chunks through one
    fp32 copy, so that the chunks' gradients of x are summed in fp32 and
    rounded to x's type once (summed in x's type, 125 chunks of gemma-7b's
    vocabulary would round the sum 125 times); the forward's bits are
    unchanged."""
    d, Vpad = lm_head.shape
    if Vpad % chunk:
        chunk = math.gcd(Vpad, chunk) or Vpad
    B, S, _ = x.shape
    m = torch.full((B, S), -1e30, device=x.device)
    s = torch.zeros((B, S), device=x.device)
    gold = torch.zeros((B, S), device=x.device)
    xf = x.float()
    for c0 in range(0, Vpad, chunk):
        m, s, gold = L.recompute(_ce_chunk, xf, lm_head[:, c0:c0 + chunk],
                                 targets, c0, vocab_size, m, s, gold)
    nll = (m + torch.log(torch.clamp(s, min=1e-30))) - gold
    nll = nll * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def _ce_chunk(xf, w, targets, c0: int, vocab_size: int, m, s, gold):
    """One vocab chunk's step of `chunked_cross_entropy`: (m, s, gold)."""
    chunk = w.shape[1]
    logits = (xf.to(w.dtype) @ w).float()                   # (B, S, chunk)
    col = c0 + torch.arange(chunk, device=logits.device)
    logits = torch.where(col < vocab_size, logits, -1e9)
    m_new = torch.maximum(m, logits.amax(-1))
    s = s * torch.exp(m - m_new) + torch.exp(
        logits - m_new[..., None]).sum(-1)
    local = targets - c0
    inside = (local >= 0) & (local < chunk)
    g = torch.gather(logits, -1,
                     torch.clamp(local, 0, chunk - 1)[..., None])[..., 0]
    return m_new, s, gold + torch.where(inside, g, 0.0)


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """Next-token LM loss plus the MoE aux loss, `repro`'s: returns
    (ce + moe_aux_weight * aux, (ce, aux)).  The whole batch goes to the
    forward (patch or source embeddings too), and the patch positions are
    cut out of the logits (or, with `cfg.fused_loss`, out of the hiddens
    before `chunked_cross_entropy`) before the loss."""
    toks = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    targets = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)
    mask = torch.ones(toks.shape, dtype=torch.float32, device=toks.device)
    mask[:, -1] = 0.0
    batch = {**batch, "tokens": toks}
    n_p = _num_patches(cfg, batch)
    if cfg.fused_loss:
        hidden, aux = forward(params, cfg, batch, mode="train_hidden")
        hidden = constrain(hidden, "dp", None, None)
        ce = chunked_cross_entropy(hidden[:, n_p:], params.lm_head, targets,
                                   cfg.vocab_size, mask)
    else:
        logits, aux = forward(params, cfg, batch, mode="train")
        logits = constrain(logits, "dp", None, "tp")
        ce = cross_entropy(logits[:, n_p:], targets, cfg.vocab_size, mask)
    return ce + cfg.moe_aux_weight * aux, (ce, aux)


def make_eval_step(cfg: ModelConfig):
    """eval_step(params, batch) -> {"loss", "ce"}, without gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        loss, (ce, _aux) = loss_fn(params, cfg, batch)
        return {"loss": loss, "ce": ce}

    return eval_step


def make_train_step(cfg: ModelConfig, optimizer, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  The gradient comes from torch autograd; the optimizer writes
    the new weights into `params` in place, and the returned params are the
    module passed in.

    microbatches > 1 accumulates gradients: the batch is split along dim 0,
    each part's gradients are summed in fp32, and the sum and the loss, ce
    and aux are scaled by 1/microbatches (`repro`'s scan over parts)."""

    def grads_of(weights, params, batch):
        with torch.enable_grad():
            for w in weights:
                w.requires_grad_(True)
            try:
                with span("train.forward"):
                    loss, (ce, aux) = loss_fn(params, cfg, batch)
                with span("train.backward"):
                    grads = torch.autograd.grad(loss, weights)
            finally:
                for w in weights:
                    w.requires_grad_(False)
        return loss.detach(), ce.detach(), aux.detach(), grads

    def train_step(params, opt_state, batch):
        with span("train.step"):
            weights = list(params.parameters())
            if microbatches == 1:
                loss, ce, aux, grads = grads_of(weights, params, batch)
            else:
                loss, ce, aux, grads = accumulated(weights, params, batch)
            with span("train.optimizer"):
                _, opt_state, gnorm = optimizer.update(weights, grads,
                                                       opt_state)
        metrics = {"loss": loss, "ce": ce, "moe_aux": aux,
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    def accumulated(weights, params, batch):
        n = len(next(iter(batch.values()))) // microbatches
        zero = torch.zeros((), device=params.embed.device)
        acc = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
               for w in weights]
        loss, ce, aux = zero, zero, zero
        for i in range(microbatches):
            part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l, c, a, grads = grads_of(weights, params, part)
            for s, g in zip(acc, grads):
                s += g.float()
            loss, ce, aux = loss + l, ce + c, aux + a
            del grads
        scale = 1.0 / microbatches
        grads = [s.mul_(scale) for s in acc]
        return loss * scale, ce * scale, aux * scale, grads

    return train_step
