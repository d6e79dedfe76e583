"""Continuous-batching serving engine — the online workload's front end.

Port of `repro/serving/engine.py`, with the same scheduling:

  * a fixed pool of B decode slots over one pre-allocated KV cache,
  * every engine step runs ONE fixed-shape decode step over all slots with
    *per-slot positions* (the model's decode path takes ragged positions),
  * new requests are admitted into free slots and their prompts are
    piggy-backed: while a slot is still prefilling, its input token is the
    next prompt token and its logits are discarded; once the prompt is
    consumed the slot switches to generation,
  * finished sequences retire and free their slot immediately.

Two differences from `repro`: the cache (`self.cache`) is updated in place by
the decode step, and the greedy argmax is taken on the device, so each step
copies B token ids to the host instead of the (B, Vpad) logits.  Greedy
results are the same.

Plain decoder LMs are served (the dense, MoE and MLA attention patterns,
jamba's hybrid of Mamba and attention, and the mLSTM); a model with a
frontend or an encoder is refused, as `repro`'s engine refuses it.  MoE
decode routes each slot's token alone (one dispatch group a row, capacity
1), so ragged slots do not disturb each other.  A reused slot is not
reset, as in `repro`: an attention slot's stale KV rows are never read
(attention reads the first pos + 1 rows), but a recurrent state is not
masked: the mLSTM's C, n, m and conv window, and Mamba's h and conv
window.  A request admitted into a freed slot starts from the state its
predecessor left, and an idle slot's state keeps evolving under the
fixed-shape step (its last token fed again).  Its tokens then differ from
`greedy_generate`'s on the same prompt (ROADMAP.md, F5).  The port keeps
this to stay equal to the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import init_cache, make_decode_step
from repro_torch.models.model import ModelConfig, Transformer


@dataclasses.dataclass
class ServeRequest:
    request_id: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int
    arrival: float = 0.0
    output: list = dataclasses.field(default_factory=list)
    done_at: float | None = None


@dataclasses.dataclass
class EngineConfig:
    num_slots: int = 8
    kv_capacity: int = 256
    eos_id: int | None = None
    greedy: bool = True


class ServingEngine:
    """Slot-based continuous batching over the port's decode step, on the
    device that holds `params`."""

    def __init__(self, cfg: ModelConfig, params: Transformer,
                 ecfg: EngineConfig = EngineConfig()):
        if cfg.frontend != "none" or cfg.enc_layers:
            raise ValueError(f"{cfg.name}: the engine serves plain decoder "
                             "LMs (no frontend, no encoder), as `repro`'s")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = params.embed.device
        B = ecfg.num_slots
        self.cache = init_cache(cfg, B, ecfg.kv_capacity, device=self.device)
        self.slot_req: list[ServeRequest | None] = [None] * B
        self.slot_pos = np.zeros(B, np.int32)       # position being written
        self.slot_prompt_left = np.zeros(B, np.int32)
        self.slot_tok = np.zeros((B, 1), np.int32)
        self.waiting: list[ServeRequest] = []
        self.finished: list[ServeRequest] = []
        self.steps = 0
        self._decode = make_decode_step(cfg)

    # -- admission ----------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        if len(req.prompt) < 1:
            raise ValueError("empty prompt")
        if len(req.prompt) + req.max_new_tokens >= self.ecfg.kv_capacity:
            raise ValueError(f"request {req.request_id} does not fit "
                             f"kv_capacity {self.ecfg.kv_capacity}")
        self.waiting.append(req)

    def _admit(self) -> None:
        for slot in range(self.ecfg.num_slots):
            if self.slot_req[slot] is not None or not self.waiting:
                continue
            req = self.waiting.pop(0)
            self.slot_req[slot] = req
            self.slot_pos[slot] = 0
            self.slot_prompt_left[slot] = len(req.prompt)
            self.slot_tok[slot, 0] = req.prompt[0]

    # -- stepping -----------------------------------------------------------
    def step(self, now: float = 0.0) -> int:
        """Admit + one fixed-shape decode step.  Returns #active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        logits, self.cache = self._decode(
            self.params, self.cache,
            torch.from_numpy(self.slot_tok).to(self.device),
            torch.from_numpy(self.slot_pos))
        self.steps += 1
        next_tok = logits[:, :self.cfg.vocab_size].argmax(-1).tolist()
        for slot in active:
            req = self.slot_req[slot]
            self.slot_pos[slot] += 1
            if self.slot_prompt_left[slot] > 1:
                # still prefilling: feed the next prompt token, drop logits
                self.slot_prompt_left[slot] -= 1
                idx = len(req.prompt) - int(self.slot_prompt_left[slot])
                self.slot_tok[slot, 0] = req.prompt[idx]
                continue
            self.slot_prompt_left[slot] = 0
            nxt = next_tok[slot]
            req.output.append(nxt)
            self.slot_tok[slot, 0] = nxt
            done = (len(req.output) >= req.max_new_tokens
                    or (self.ecfg.eos_id is not None
                        and nxt == self.ecfg.eos_id)
                    or self.slot_pos[slot] >= self.ecfg.kv_capacity - 1)
            if done:
                req.done_at = now
                self.finished.append(req)
                self.slot_req[slot] = None
                self.slot_pos[slot] = 0
        return len(active)

    def drain(self, max_steps: int = 100_000) -> None:
        while self.waiting or any(r is not None for r in self.slot_req):
            self.step()
            max_steps -= 1
            if max_steps <= 0:
                raise RuntimeError("engine did not drain")

    @property
    def active_slots(self) -> int:
        return sum(r is not None for r in self.slot_req)
