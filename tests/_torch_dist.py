"""Multi-process cases of tests/test_torch_distributed.py: run as
`python tests/_torch_dist.py CASE INPUTS OUT`, it spawns the case's gloo
ranks on the CPU; rank 0 writes the case's results as JSON to OUT.  INPUTS
is a pickle the test wrote (numpy weights and inputs, `repro`'s
results)."""
import contextlib
import json
import os
import pickle
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)             # chip_smoke's same-inputs check

WORLD = {"train": 4, "moe": 4, "decode": 2}


def _f(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def case_train(inp: dict) -> dict:
    """The train step sharded over (2, 2) and (1, 4) against the port's
    unsharded step, then the launcher on (2, 2) resumed on (4, 1), then
    `mixers`."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import make_train_step
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.sharding import (activation_mesh, batch_sharding,
                                      opt_state_sharding, param_sharding)
    from repro_torch.sharding.rules import (distribute, distribute_params,
                                            distribute_tree)
    out = {}
    for arch, case in inp["train"].items():
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32, **case["overrides"])
        opt = AdamW(AdamWConfig(lr=1e-3, total_steps=10))
        toks = torch.from_numpy(case["tokens"])
        ref = params_from_jax(case["params"], cfg, device="cpu")
        w_ref = list(ref.parameters())
        _, _, m = make_train_step(cfg, opt)(ref, opt.init(w_ref),
                                            {"tokens": toks})
        for shape in ((2, 2), (1, 4)):
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            model = params_from_jax(case["params"], cfg, device="cpu")
            with activation_mesh(mesh):
                specs = param_sharding(mesh, model, mode="train")
                distribute_params(model, mesh, specs)
                weights = list(model.parameters())
                state = opt.init(weights)
                state = distribute_tree(state, mesh, opt_state_sharding(
                    mesh, specs, state), src_data_rank=None)
                b = {"tokens": distribute(toks, mesh, batch_sharding(
                    mesh, {"tokens": toks})["tokens"])}
                _, _, ms = make_train_step(cfg, opt)(model, state, b)
                loss = float(ms["loss"].full_tensor())
                diff = max(float(np.abs(_f(w) - _f(r)).max())
                           for w, r in zip(weights, w_ref))
            out[f"{arch}/{shape}"] = {"loss": loss,
                                      "unsharded": float(m["loss"]),
                                      "param_diff": diff}
    ckpt = inp["ckpt_dir"]
    kw = dict(smoke=True, steps=4, batch=8, seq=32, ckpt_every=2,
              device="cpu", log_every=100)
    whole = train.run("h2o-danube-1.8b", mesh_shape=(2, 2), ckpt_dir=ckpt,
                      **kw)["losses"]
    if dist.get_rank() == 0:
        import shutil
        shutil.rmtree(os.path.join(ckpt, "step_00000004"))
    dist.barrier()
    resumed = train.run("h2o-danube-1.8b", mesh_shape=(4, 1), ckpt_dir=ckpt,
                        **kw)["losses"]
    out["launcher"] = {"whole": whole, "resumed": resumed}
    out["mixers"] = mixers()
    return out


def case_moe(inp: dict) -> dict:
    """moe_a2a_dispatch on (2, 2): y and the gradient of sum(y) in x."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as M
    from repro_torch.sharding import activation_mesh
    from repro_torch.sharding.rules import distribute, distribute_params
    cfg = dataclasses.replace(get_config(inp["arch"], smoke=True),
                              dtype=torch.float32)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for cf in (100.0, 1.25):
        moe = M.MoE(cfg, "cpu")
        moe.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                             for k, v in inp["moe"].items()})
        with activation_mesh(mesh):
            specs = {n: (("model", None, None) if p.ndim == 3
                         else (None,) * p.ndim)
                     for n, p in moe.named_parameters()}
            distribute_params(moe, mesh, specs)
            x = torch.from_numpy(inp["x"]).requires_grad_(True)
            xd = distribute(x.detach(), mesh, ("data", None, None))
            xd.requires_grad_(True)
            y, aux = M.moe_a2a_dispatch(moe, xd, cfg, cf)
            (g,) = torch.autograd.grad(y.sum(), xd)
        out[str(cf)] = {"y": _f(y).tolist(), "grad": _f(g).tolist(),
                        "aux": float(_f(aux))}
    return out


def decode_run(cfg, case: dict, toks, S0: int, mesh=None, check=None):
    """Prefill of toks[:, :S0], then decode teacher-forced through the rest,
    on `case`'s weights (`repro`'s, through params_from_jax), on `mesh` or
    on one device: (every step's logits, stacked; what `check(params)`,
    a context the run goes through when given, yielded)."""
    from repro_torch.models import init_cache
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.steps import (_copy_prefix_cache,
                                          make_decode_step, make_prefill)
    from repro_torch.sharding import cache_sharding, param_sharding
    from repro_torch.sharding.rules import distribute_params, distribute_tree
    steps = toks.shape[1] - S0
    params = params_from_jax(case["params"], cfg, device="cpu")
    cache = init_cache(cfg, 1, S0 + steps, device="cpu")
    if mesh is not None:
        distribute_params(params, mesh, param_sharding(mesh, params,
                                                       mode="serve"))
        cache = distribute_tree(cache, mesh, cache_sharding(mesh, cache),
                                src_data_rank=None)
    with check(params) if check else contextlib.nullcontext() as rec:
        logits, pre = make_prefill(cfg)(params, {"tokens": toks[:, :S0]})
        cache = _copy_prefix_cache(pre, cache)
        decode = make_decode_step(cfg)
        outs = [_f(logits)]
        for i in range(steps):
            logits, cache = decode(params, cache,
                                   toks[:, S0 + i:S0 + i + 1], S0 + i)
            outs.append(_f(logits))
    return np.stack(outs), rec


@contextlib.contextmanager
def bf16_partials():
    """The merge before it rounded once: each rank's partial output of the
    sequence-split decode rounded to q's type before the ranks merge it
    (`ops._sharded_decode` reaches `ops.decode_attention` with
    return_lse only there)."""
    from repro_torch.kernels import ops
    inner = ops.decode_attention

    def rounded(q, k_cache, v_cache, kv_len, softcap=None, return_lse=False):
        res = inner(q, k_cache, v_cache, kv_len, softcap, return_lse)
        return (res[0].to(q.dtype), res[1]) if return_lse else res
    ops.decode_attention = rounded
    try:
        yield
    finally:
        ops.decode_attention = inner


def case_decode(inp: dict) -> dict:
    """Prefill and decode under (1, 2) and (2, 1) meshes at B1 (the second
    splits the cache's sequence over `data`) and without a mesh, on
    `repro`'s weights: each mesh's logits, and their distance from the
    unsharded port's.  Then, under "bf16", h2o-danube-1.8b in bf16 on
    both meshes through chip_smoke's same-inputs check of the cross-rank
    reductions, and on (2, 1) again with the ranks' partial outputs
    rounded to bf16 before the merge (`bf16_partials`): each run's
    distance from the unsharded port's logits and each site's worst
    layer."""
    import dataclasses
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import activation_mesh
    out = {}
    S0 = inp["prefix"]
    for arch, case in inp["decode"].items():
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32, **case["overrides"])
        toks = torch.from_numpy(case["tokens"])
        want = decode_run(cfg, case, toks, S0)[0]
        for shape in ((1, 2), (2, 1)):
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            with activation_mesh(mesh):
                got = decode_run(cfg, case, toks, S0, mesh)[0]
            out[f"{arch}/{shape}"] = {
                "logits": got.tolist(),
                "unsharded": float(np.abs(got - want).max()
                                   / np.abs(want).max())}
    arch = "h2o-danube-1.8b"
    case = inp["decode"][arch]
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.bfloat16)
    toks = torch.from_numpy(case["tokens"])
    want = decode_run(cfg, case, toks, S0)[0]
    bf16 = out["bf16"] = {}

    def check(params):
        return chip_smoke.same_inputs_check(
            torch, params, cfg.num_layers,
            lambda t: chip_smoke.gather_shards(torch, t))
    for name, shape, old in (("(2, 1)", (2, 1), False),
                             ("(1, 2)", (1, 2), False),
                             ("(2, 1)/bf16_partials", (2, 1), True)):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        with activation_mesh(mesh), \
                bf16_partials() if old else contextlib.nullcontext():
            got, rec = decode_run(cfg, case, toks, S0, mesh, check)
        worst = chip_smoke.same_inputs_worst(rec)
        bf16[name] = {
            "bitwise": bool(np.array_equal(got, want)),
            "unsharded": float(np.abs(got - want).max()
                               / np.abs(want).max()),
            "worst": worst,
            "problems": chip_smoke.same_inputs_problems(worst),
            "layers": chip_smoke.same_inputs_layers(rec)}
    return out


def mixers() -> dict:
    """The Mamba and mLSTM mixers (train forward, the gradients of
    sum(y**2), the final state or carry, a second forward from that
    state, and a decode step from a random state) on (1, 4) and (2, 2)
    against the same mixers on one device: the largest difference of
    each run."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ssm
    from repro_torch.sharding import activation_mesh, param_sharding
    from repro_torch.sharding.rules import distribute, distribute_params
    out = {}
    for arch, over, B in (("jamba-1.5-large-398b", {}, 2),
                          ("xlstm-350m", {"num_heads": 1}, 2)):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32, **over)
        kind = ssm.Mamba if arch.startswith("jamba") else ssm.MLSTM
        mixer = (ssm.mamba_mixer if kind is ssm.Mamba else ssm.mlstm_mixer)
        step = (ssm.mamba_decode_step if kind is ssm.Mamba
                else ssm.mlstm_decode_step)
        init = (ssm.mamba_state_init if kind is ssm.Mamba
                else ssm.mlstm_state_init)
        g = torch.Generator().manual_seed(0)
        ref = kind(cfg, "cpu")
        with torch.no_grad():
            for w in ref.parameters():
                w.copy_(torch.randn(w.shape, generator=g) * 0.1)
        x = torch.randn((B, 16, cfg.d_model), generator=g)
        x1 = torch.randn((B, 1, cfg.d_model), generator=g)
        st = init(B, cfg, "cpu")
        st = {k: (tuple(torch.randn(t.shape, generator=g) for t in v)
                  if isinstance(v, tuple) else torch.randn(v.shape,
                                                           generator=g))
              for k, v in st.items()}

        def run(mix, x, x1, st):
            x = x.detach().requires_grad_(True)
            ws = [w.requires_grad_(True) for w in mix.parameters()]
            y, last = mixer(mix, x, cfg)
            grads = torch.autograd.grad(y.square().sum(), [x] + ws)
            with torch.no_grad():
                y2, _ = mixer(mix, x, cfg, last)
            yd, sd = step(mix, x1, st, cfg)
            last = last if isinstance(last, tuple) else (last,)
            sd = [t for v in sd.values()
                  for t in (v if isinstance(v, tuple) else (v,))]
            return [_f(t) for t in (y, *last, *grads, y2, yd, *sd)]

        want = run(ref, x, x1, st)
        for shape in ((1, 4), (2, 2)):
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            mix = kind(cfg, "cpu")
            mix.load_state_dict(ref.state_dict())
            with activation_mesh(mesh):
                distribute_params(mix, mesh, param_sharding(mesh, mix,
                                                            mode="train"))
                specs = {"h": ("data", "model", None),
                         "conv": ("data", None, "model"),
                         "carry": (("data", None, "model", None),
                                   ("data", None, "model"),
                                   ("data", None))}
                dst = {k: (tuple(distribute(t, mesh, sp) for t, sp in
                                 zip(v, specs[k])) if isinstance(v, tuple)
                           else distribute(v, mesh, specs[k]))
                       for k, v in st.items()}
                got = run(mix, distribute(x, mesh, ("data", None, None)),
                          distribute(x1, mesh, ("data", None, None)), dst)
            out[f"{arch}/H{cfg.num_heads}/{shape}"] = max(
                float(np.abs(a - b).max()) for a, b in zip(got, want))
    return out


def _worker(rank: int, world: int, port: int, case: str, inp, out_path):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    try:
        res = globals()[f"case_{case}"](inp)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def main() -> None:
    case, inp_path, out_path = sys.argv[1:4]
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(WORLD[case], port, case, inp, out_path),
             nprocs=WORLD[case])


if __name__ == "__main__":
    main()
