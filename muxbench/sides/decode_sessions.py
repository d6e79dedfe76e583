"""Online side: single-token requests of standing decode sessions.

Set-up fills a cache of `sessions` rows by the program's prefill of
seeded prompts of `prompt_len` tokens and copies it into a decode cache of
`cache_rows` rows, as `greedy_generate` does.  Each online step is one
call of the program's decode step over every session at once: each row
advances one position, fed the seeded token of that step and row.  A
request takes the next free row of the step that serves it, and its answer
is the token the step puts first in that row.  The fed tokens do not
depend on when requests come, so the reference can follow every row.

The check runs the reference over each row's prompt and fed tokens in
fp32 and reads:
  * `served_gap`: over every request, how far the reference's logit of the
    served token lies below the reference's best, the widest;
  * `served_miss_pct`: the share of requests whose served token is not
    the reference's first;
  * `logits_rel`: over the prefill's logits and a seeded sample of steps,
    the last included, the largest relative L2 distance of a row's logits
    from the reference's.
"""
from __future__ import annotations

import torch

from muxbench import weights


class Side:
    kind = "online"

    def __init__(self, ctx, spec: dict):
        self.ctx, self.spec = ctx, spec
        self.B, self.P = spec["sessions"], spec["prompt_len"]
        self.room = spec["cache_rows"] - self.P

    def setup(self, params) -> None:
        from repro_torch.models import init_cache, make_decode_step, make_prefill
        ctx, spec, dev = self.ctx, self.spec, self.ctx.device
        V = ctx.model["vocab_size"]
        self.params = params
        self.prompts = weights.tokens(ctx.seed, "prompts", (self.B, self.P), V,
                                      dev)
        self.fed = weights.tokens(ctx.seed, "tokens", (self.room, self.B), V,
                                  dev)
        self.served = torch.zeros((self.room, self.B), dtype=torch.long,
                                  device=dev)
        pick = torch.rand(self.room, generator=weights.generator(
            ctx.seed, "sample", "cpu")) < spec["sample_share"]
        self.sample = set(torch.nonzero(pick)[:, 0].tolist())
        logits, cache = make_prefill(ctx.cfg)(params, {"tokens": self.prompts})
        self.kept = {-1: logits}
        self.cache = init_cache(ctx.cfg, self.B, spec["cache_rows"], device=dev)
        for src, dst in zip(cache, self.cache):
            for name, t in src.items():
                dst[name][:, :, :t.shape[2]].copy_(t)
        del cache, logits
        self.decode = make_decode_step(ctx.cfg)
        self.i = 0
        for _ in range(spec["warmup_steps"]):
            self.step()

    def measure_base(self) -> None:
        """The decode step's time alone, which the throttle's PID divides
        each online step by: the slowest of `base_steps` timed steps, taken
        last in set-up (after the offline side's first steps).  The step is
        host-bound, and a base from quick steps on a quiet host is one that
        the window's steps overrun, which the PID answers by starving the
        offline side for the rest of the run."""
        times = []
        for _ in range(self.spec["base_steps"]):
            t = self.ctx.clock()
            self.step()
            times.append(self.ctx.clock() - t)
        self.base_s = max(times)

    def step(self, rows: int = 0) -> int:
        """One decode step of every session; returns its index."""
        i = self.i
        if i >= self.room:
            raise RuntimeError(f"the decode cache's {self.room} free rows are "
                               "used up: the mix offers more requests than "
                               "its cache_rows hold")
        logits, _ = self.decode(self.params, self.cache, self.fed[i][:, None],
                                self.P + i)
        self.served[i] = logits[:, :self.ctx.model["vocab_size"]].argmax(-1)
        if i in self.sample:
            self.kept[i] = logits
        self.last = (i, logits)
        self.ctx.sync()
        self.i += 1
        return i

    def room_for(self, requests: int) -> bool:
        return self.i + requests <= self.room

    def work(self, i: int) -> dict:
        """Model FLOPs of step i and each kernel call's least time at the
        peaks, from the configuration's reference module."""
        ctx = self.ctx
        return ctx.ref.decode_step_work(ctx.model, self.B, self.P + i,
                                        ctx.dtype_name)

    def counters(self) -> dict:
        """The decode step's own counts: steps replayed from a CUDA graph,
        graphs captured, steps run eagerly."""
        return {k: getattr(self.decode, k)
                for k in ("replays", "captures", "eager")}

    def close(self) -> None:
        """Keeps the outputs to be judged on the host; drops the program's
        state."""
        n = self.i
        i, logits = self.last
        self.kept[i] = logits
        self.out = {"n": n, "served": self.served[:n].cpu(),
                    "kept": {s: t.float().cpu() for s, t in self.kept.items()},
                    "prompts": self.prompts.cpu(), "fed": self.fed[:n].cpu()}
        for name in ("params", "cache", "kept", "last", "served", "prompts",
                     "fed", "decode"):
            setattr(self, name, None)

    def check(self, rec, ref, w: dict) -> dict:
        """{name: value} of the compared numbers, from the reference's
        logits of every row.  rec: the loop's record (which step and row
        served each request)."""
        ctx, out = self.ctx, self.out
        m, V, dev = ctx.model, ctx.model["vocab_size"], ctx.device
        # request j sits in row r of the step that served it, in FIFO order
        rows = {}
        for s in rec.spans:
            if s.kind == "online":
                for r in range(s.requests):
                    rows.setdefault(r, []).append(s.step)
        gaps, rels = [], []
        with torch.no_grad():
            for b in range(self.B):
                L = row_logits(ref, w, m, out["prompts"][b], out["fed"][:, b],
                               ctx.served, dev)
                steps = torch.tensor(rows.get(b, []), dtype=torch.long)
                if steps.numel():
                    gaps.append(served_gaps(L[steps + 1],
                                            out["served"][steps, b].to(dev)))
                for s, kl in out["kept"].items():
                    rels.append(logits_rel(kl[b, :V].to(dev), L[s + 1]))
                del L
        return numbers(torch.cat(gaps), torch.tensor(rels))


def served_gaps(L: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far the reference's logit (L, one row a request) of each
    served token lies below the reference's best, on the host."""
    return (L.max(-1).values - L.gather(1, served[:, None])[:, 0]).cpu()


def logits_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def numbers(gaps: torch.Tensor, rels: torch.Tensor) -> dict:
    """The online side's readings: the widest served gap, the share of
    requests whose served token is not the reference's first (%), and the
    largest relative logit distance."""
    return {"served_gap": float(gaps.max()) if len(gaps) else 0.0,
            "served_miss_pct": 100.0 * float((gaps > 0).float().mean())
            if len(gaps) else 0.0,
            "logits_rel": float(rels.max())}


def row_logits(ref, w: dict, m: dict, prompt, fed, served, dev,
               mm=torch.matmul) -> torch.Tensor:
    """The reference's logits of one session, (len(fed) + 1, vocab): row 0
    after the prompt (the prefill's), row j + 1 after fed token j."""
    P = len(prompt)
    seq = torch.cat([prompt, fed])[None].to(dev)
    return ref.forward(w, m, seq, served=served, logits_from=P - 1, mm=mm)[0]
