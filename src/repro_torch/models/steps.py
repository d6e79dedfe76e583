"""Step functions: the decode step MuxFlow protects (the online workload),
the prefill and greedy generation around it, and the train and eval steps
of the offline workload."""
from __future__ import annotations

import torch

from .model import ModelConfig, forward, init_cache


def make_prefill(cfg: ModelConfig):
    """prefill(params, batch) -> (next-token logits (B, Vpad), cache)."""

    @torch.no_grad()
    def prefill(params, batch):
        logits, cache, _aux = forward(params, cfg, batch, mode="prefill")
        return logits, cache

    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, cache, tokens (B,1), pos) -> (logits (B,Vpad),
    cache): one token for the whole batch against the standing cache, which
    is updated in place."""

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        return forward(params, cfg, {"tokens": tokens}, mode="decode",
                       cache=cache, pos=pos)

    return decode_step


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
    taken whole."""
    out = []
    for s, d in zip(src, dst):
        d = dict(d)
        for name, v in s.items():
            if name in ("k", "v", "xk", "xv", "ckv", "kr"):
                d[name][:, :, :v.shape[2]].copy_(v)
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
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """Next-token LM loss plus the MoE aux loss, `repro`'s: returns
    (ce + moe_aux_weight * aux, (ce, aux)).  The whole batch goes to the
    forward (patch or source embeddings too), and the patch positions are
    cut out of the logits before the loss."""
    toks = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    targets = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)
    mask = torch.ones(toks.shape, dtype=torch.float32, device=toks.device)
    mask[:, -1] = 0.0
    logits, aux = forward(params, cfg, {**batch, "tokens": toks},
                          mode="train")
    n_p = _num_patches(cfg, batch)
    if n_p:
        logits = logits[:, n_p:]
    ce = cross_entropy(logits, targets, cfg.vocab_size, mask)
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
                loss, (ce, aux) = loss_fn(params, cfg, batch)
                grads = torch.autograd.grad(loss, weights)
            finally:
                for w in weights:
                    w.requires_grad_(False)
        return loss.detach(), ce.detach(), aux.detach(), grads

    def train_step(params, opt_state, batch):
        weights = list(params.parameters())
        if microbatches == 1:
            loss, ce, aux, grads = grads_of(weights, params, batch)
        else:
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
            loss, ce, aux = loss * scale, ce * scale, aux * scale
        _, opt_state, gnorm = optimizer.update(weights, grads, opt_state)
        metrics = {"loss": loss, "ce": ce, "moe_aux": aux,
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step
