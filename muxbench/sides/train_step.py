"""Offline side: a fine-tuning job's train steps with AdamW.

Set-up builds the program's train step (`make_train_step` with its
`AdamW`) on a second copy of the weights, and runs its first
`checked_steps` steps through the same call and feed as the window's, on
seeded batches of `batch` x `seq` tokens whose rows all differ.  Those
first steps are the ones the reference follows from the seed's weights;
the window goes on from the state they leave.

One window step is checked too: the first that starts after a time drawn
from the seed, uniformly between the shares `check_window` of the window
(or, where none starts after it, one more step through the same call once
the window has closed).  The weights the optimizer keeps are copied before
it and its moments after it, into buffers made in set-up; the reference
then follows the program from the program's own state there, since it
cannot afford the window's tens of steps.  Its gradient is not compared:
some tens of steps in, the loss of this job (uniform tokens) has stopped
falling, and the backward through the 24 layers is so ill-conditioned
there that two fp32 implementations, the port's and the reference's, read
gradients of the first layers 40 % apart from the same weights, whose
losses agree to 1e-6.  The set-up steps hold the gradient.

The check runs the steps in the fp32 reference and compares, each as a
relative gap (|program - reference| / reference):
  * `loss_rel`: each set-up step's loss, the worst step;
  * `grad_norm_rel`: the first step's global gradient norm before
    clipping, which the train step returns;
  * `grad_leaf_rel`: each weight's norm of the first gradient as AdamW
    got it (clipped), worked out from its first moment after one step;
  * `update_leaf_rel`: each weight's norm of its change over the set-up
    steps, as the optimizer keeps it for the next step (the fp32 master
    copy where there is one);
  * `window_loss_rel`: the checked window step's loss, against the
    reference's from the weights kept before it, on the step's own batch;
  * `window_update_leaf_rel`: each weight's norm of its change at that
    step, against AdamW's change worked out by the reference from those
    weights and the program's moments after the step.
The numbers by weight are taken at the worst weight, against the larger
of that weight's reference norm and the median weight's; weights whose
reference gradient is under a thousandth of the median weight's are left
out of `update_leaf_rel`.
"""
from __future__ import annotations

import torch

from muxbench import weights


def leaf_gap(prog: list, refn: list, skip=()) -> float:
    """Worst |prog - ref| / max(ref, median ref) over the weights not in
    `skip`."""
    ref_t = torch.tensor(refn)
    med = float(ref_t.median())
    return max(abs(p - r) / max(r, med)
               for j, (p, r) in enumerate(zip(prog, refn)) if j not in skip)


def norms(ts) -> list:
    """The L2 norm of each tensor of the iterable `ts`, read at once."""
    return torch.stack([torch.linalg.vector_norm(t) for t in ts]).tolist()


class Side:
    kind = "offline"

    def __init__(self, ctx, spec: dict):
        self.ctx, self.spec = ctx, spec
        self.B, self.S = spec["batch"], spec["seq"]
        self.tokens_per_step = self.B * self.S
        self.check_at = None      # clock time after which a step is checked
        self.win = None           # the checked window step's readings
        self.after_close = False  # the checked step came after the close

    def setup(self, params, initial: dict) -> None:
        from repro_torch.models import make_train_step
        from repro_torch.optim import AdamW, AdamWConfig
        ctx, spec = self.ctx, self.spec
        self.names = [n for n, _ in params.named_parameters()]
        self.opt = AdamW(AdamWConfig(**spec["adamw"]))
        self.params = params
        self.state = self.opt.init(params.parameters())
        self.train = make_train_step(ctx.cfg, self.opt)
        self.batches = weights.tokens(
            ctx.seed, "batches", (spec["batches"], self.B, self.S),
            ctx.model["vocab_size"], ctx.device)
        self.k = 0
        self.losses, self.prog = [], {}
        b1 = spec["adamw"]["b1"]
        for t in range(spec["checked_steps"]):
            met = self.step(metrics=True)
            self.losses.append(float(met["loss"]))
            if t == 0:
                self.prog["grad_norm"] = float(met["grad_norm"])
                self.prog["grad_leaf"] = [
                    float(torch.linalg.vector_norm(mo)) / (1 - b1)
                    for mo in self.state["m"]]
        self.prog["update_leaf"] = [
            float(torch.linalg.vector_norm(p.float() - initial[n].float()))
            for n, p in zip(self.names, self.kept())]
        self.first_batches = self.batches[:spec["checked_steps"]].cpu()

    def kept(self) -> list:
        """The weights the optimizer keeps for the next step."""
        return self.state.get("master", list(self.params.parameters()))

    def reserve(self) -> None:
        """Buffers for the checked window step's weights before it and
        moments after it, made in set-up so that the window allocates
        nothing for the check."""
        self.kept_w = [torch.empty_like(t) for t in self.kept()]
        self.kept_m = [torch.empty_like(t) for t in self.state["m"]]
        self.kept_v = [torch.empty_like(t) for t in self.state["v"]]

    def arm(self, t_window: float, seconds: float) -> None:
        """The window starts at clock time t_window: the first step that
        starts after a seeded time within it is checked."""
        lo, hi = self.spec["check_window"]
        g = weights.generator(self.ctx.seed, "check", "cpu")
        frac = lo + (hi - lo) * float(torch.rand((), generator=g))
        self.check_at = t_window + frac * seconds

    def step(self, metrics: bool = False):
        """One train step on the next batch; returns its index (or its
        metrics)."""
        k = self.k
        checked = (self.win is None and self.check_at is not None
                   and self.ctx.clock() >= self.check_at)
        if checked:
            t = self.ctx.clock()
            torch._foreach_copy_(self.kept_w, self.kept())
            step0 = int(self.state["step"])      # waits for the copy
            t_copy = self.ctx.clock() - t
        b = self.batches[k % len(self.batches)]
        self.params, self.state, met = self.train(self.params, self.state,
                                                  {"tokens": b})
        if checked:
            self.ctx.sync()
            t = self.ctx.clock()
            self.win = self.read_step(k, step0, met, b)
            self.win["extra_s"] = t_copy + self.ctx.clock() - t
        self.ctx.sync()
        self.k += 1
        return met if metrics else k

    @torch.no_grad()
    def read_step(self, k: int, step0: int, met: dict, batch) -> dict:
        """The program's readings of the step just taken (its moments kept,
        each weight's change from the copy before it, one weight's
        temporary at a time)."""
        torch._foreach_copy_(self.kept_m, self.state["m"])
        torch._foreach_copy_(self.kept_v, self.state["v"])
        u = norms(p.float() - q.float()
                  for p, q in zip(self.kept(), self.kept_w))
        return {"k": k, "step": step0 + 1, "loss": float(met["loss"]),
                "update_leaf": u, "batch": batch.clone()}

    def work(self, i: int) -> dict:
        """Model FLOPs of a step and its tokens, from the configuration's
        reference module."""
        ctx = self.ctx
        return {**ctx.ref.train_step_work(ctx.model, self.B, self.S,
                                          ctx.dtype_name),
                "tokens": self.tokens_per_step}

    def counters(self) -> dict:
        """The job counts nothing of its own: the throttle's counts are
        the loop's."""
        return {}

    def step_after_close(self) -> int:
        """One more step through the same call once the window has
        closed, checked where the window checked none."""
        if self.win is None:
            self.after_close = True
            self.check_at = float("-inf")
        return self.step()

    def close(self) -> None:
        """Checks one step after the close where the window checked none;
        drops the program's state (the copy of the checked step's state
        stays for the reference)."""
        if self.win is None:
            self.step_after_close()
        for name in ("params", "state", "train", "batches", "opt"):
            setattr(self, name, None)

    def check(self, rec, ref, w: dict) -> dict:
        """Runs the set-up steps in the reference (which draws its own
        copy of the weights, `w`, fp32), then the checked window step from
        the program's state before it, and returns the compared gaps."""
        ctx, spec = self.ctx, self.spec
        got = reference_steps(ref, w, ctx.model, self.names,
                              self.first_batches.to(ctx.device),
                              spec["adamw"], ctx.served)
        out = gaps({"losses": self.losses, **self.prog}, got)
        del got
        win = self.win
        refr = window_reference(ref, self.kept_w, self.kept_m, self.kept_v,
                                win["step"], ctx.model, self.names,
                                win["batch"], spec["adamw"], ctx.served)
        out.update(window_gaps(win, refr))
        out.update(window_step=win["k"], window_step_after_close=int(
            self.after_close), window_check_ms=1e3 * win["extra_s"])
        self.kept_w = self.kept_m = self.kept_v = self.win = None
        return out


def reference_steps(ref, w: dict, m: dict, names: list, batches, h: dict,
                    served, mm=torch.matmul, keep: bool = False) -> dict:
    """The reference's readings of len(batches) AdamW steps from the
    weights `w` (fp32, changed in place): each step's loss, the first
    step's global gradient norm and each weight's clipped gradient norm,
    and each weight's change over the steps.  `mm` is the projections'
    product (the control's lower precision).  With `keep`, "state" holds
    the weights, the moments and the step count after the steps."""
    initial = {n: t.clone() for n, t in w.items()}
    params = [w[n].requires_grad_(True) for n in names]
    state, out = {}, {"losses": []}
    for t in range(len(batches)):
        loss = ref.loss(w, m, batches[t], served=served, mm=mm)
        grads = torch.autograd.grad(loss, params)
        out["losses"].append(float(loss.detach()))
        gnorm, clipped = ref.adamw_step(params, list(grads), state, h)
        if t == 0:
            out["grad_norm"] = float(gnorm)
            out["grad_leaf"] = [float(torch.linalg.vector_norm(g))
                                for g in clipped]
        del grads, clipped
    out["update_leaf"] = [float(torch.linalg.vector_norm(p.detach()
                                                         - initial[n]))
                          for n, p in zip(names, params)]
    if keep:
        out["state"] = {"w": [p.detach() for p in params], "m": state["m"],
                        "v": state["v"], "step": state["step"]}
    return out


def window_reference(ref, w0: list, m1: list, v1: list, t: int, m: dict,
                     names: list, batch, h: dict, served, mm=torch.matmul,
                     dtype=torch.float32) -> dict:
    """The reference's readings of AdamW step t from the weights w0 and
    the moments m1, v1 after it: the loss of `batch` at w0 and each
    weight's change.  `mm` and `dtype` are the projections' product and
    the update's type (the control's lower precisions)."""
    with torch.no_grad():
        loss = ref.loss(dict(zip(names, [x.float() for x in w0])), m, batch,
                        served=served, mm=mm)
        upd = norms(ref.adamw_update(p.to(dtype), mo.to(dtype), v.to(dtype),
                                     t, h).float()
                    for p, mo, v in zip(w0, m1, v1))
    return {"loss": float(loss), "update_leaf": upd}


def gaps(prog: dict, refr: dict) -> dict:
    """The compared numbers of `prog`'s readings of the set-up steps
    against `refr`'s."""
    med = float(torch.tensor(refr["grad_leaf"]).median())
    still = {j for j, g in enumerate(refr["grad_leaf"]) if g < 1e-3 * med}
    return {
        "loss_rel": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], refr["losses"])),
        "grad_norm_rel": abs(prog["grad_norm"] - refr["grad_norm"])
        / refr["grad_norm"],
        "grad_leaf_rel": leaf_gap(prog["grad_leaf"], refr["grad_leaf"]),
        "update_leaf_rel": leaf_gap(prog["update_leaf"], refr["update_leaf"],
                                    still),
        "update_leaves_left_out": len(still)}


def window_gaps(prog: dict, refr: dict) -> dict:
    """The compared numbers of the checked window step's readings against
    `refr`'s."""
    return {
        "window_loss_rel": abs(prog["loss"] - refr["loss"]) / abs(refr["loss"]),
        "window_update_leaf_rel": leaf_gap(prog["update_leaf"],
                                           refr["update_leaf"])}
