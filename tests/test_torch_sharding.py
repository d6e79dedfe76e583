"""The port's sharding rules, shapes and activation constraints against
`repro`'s, in one process: every parameter, cache, batch and optimizer-state
spec of every config at FULL on the production meshes, exactly, through
`jax.sharding.AbstractMesh` on `repro`'s side and the port's
`AbstractMesh` (no devices, no process group) on its own."""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import batch_specs as jax_batch_specs
from repro.configs import decode_specs as jax_decode_specs
from repro.configs import get_config as jax_get_config
from repro.configs import supports_shape as jax_supports_shape
from repro.models import init_params as jax_init_params
from repro.optim.optimizer import AdamW as JaxAdamW
from repro.optim.optimizer import AdamWConfig as JaxAdamWConfig
from repro.sharding import context as jctx
from repro.sharding import rules as jrules
from repro_torch.configs import (SHAPES, batch_specs, decode_specs,
                                 get_config, supports_shape)
from repro_torch.launch.mesh import AbstractMesh, dp_axes, tp_axis
from repro_torch.models.model import Transformer
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.sharding import context, rules

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("train", "serve", "serve_big")


def meshes(name):
    shape, axes = MESHES[name]
    return JaxAbstractMesh(shape, axes), AbstractMesh(shape, axes)


@functools.cache
def jax_params(arch):
    cfg = jax_get_config(arch)
    return jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg))


@functools.cache
def port_model(arch):
    return Transformer(get_config(arch), "meta")


def _key(e):
    return getattr(e, "key", getattr(e, "idx", None))


def jax_param_specs(arch, tree) -> dict:
    """{port parameter name: spec} of a `repro` tree of shardings (or of
    anything with .spec), stacked leaves unstacked: entry r of blocks[i]
    is the port's layer r * P + i, with the leading None dropped."""
    cfg = jax_get_config(arch)
    P = len(cfg.pattern)
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        keys = [_key(e) for e in path]
        spec = tuple(sh.spec)
        if keys[0] == "blocks":
            assert spec[0] is None, (keys, spec)
            for r in range(cfg.repeats):
                name = ".".join(str(k) for k in keys[2:])
                out[f"blocks.{r * P + keys[1]}.{name}"] = spec[1:]
        elif keys[0] == "enc_blocks":
            assert spec[0] is None, (keys, spec)
            for r in range(cfg.enc_layers):
                out[f"enc_blocks.{r}." + ".".join(map(str, keys[1:]))] = \
                    spec[1:]
        else:
            out[".".join(map(str, keys))] = spec
    return out


def padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_repro(arch, mesh, mode):
    jmesh, pmesh = meshes(mesh)
    want = jax_param_specs(arch, jrules.param_sharding(
        jmesh, jax_params(arch), mode=mode))
    model = port_model(arch)
    got = rules.param_sharding(pmesh, model, mode=mode)
    assert set(got) == set(want)
    for name, p in model.named_parameters():
        assert got[name] == padded(want[name], p.ndim), name


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_repro(arch, mesh, shape):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    ok, reason = supports_shape(cfg, SHAPES[shape])
    assert (ok, reason) == jax_supports_shape(jcfg, JAX_SHAPES[shape])
    if not ok:
        return
    jmesh, pmesh = meshes(mesh)
    jc = jax_decode_specs(jcfg, JAX_SHAPES[shape])["cache"]
    pc = decode_specs(cfg, SHAPES[shape])["cache"]
    want = jrules.cache_sharding(jmesh, jc)
    got = rules.cache_sharding(pmesh, pc)
    assert len(got) == len(want) == len(pc)
    for g, w, c, jcc in zip(got, want, pc, jc):
        assert set(g) == set(w) == set(c)
        for name in g:
            assert tuple(c[name].shape) == jcc[name].shape, name
            assert g[name] == padded(w[name].spec, c[name].ndim), name


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_equal_repro(mesh, shape):
    jmesh, pmesh = meshes(mesh)
    for arch in ARCH_IDS:
        jb = jax_batch_specs(jax_get_config(arch), JAX_SHAPES[shape])
        pb = batch_specs(get_config(arch), SHAPES[shape])
        want = jrules.batch_sharding(jmesh, jb)
        got = rules.batch_sharding(pmesh, pb)
        for k in jb:
            assert got[k] == padded(want[k].spec, len(pb[k].shape)), (arch, k)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b"])
def test_opt_state_specs_equal_repro(arch):
    jmesh, pmesh = meshes("2x16x16")
    jp = jax_params(arch)
    jsh = jrules.param_sharding(jmesh, jp, mode="train")
    jstate = jax.eval_shape(JaxAdamW(JaxAdamWConfig()).init, jp)
    jo = jrules.opt_state_sharding(jmesh, jsh, jstate)
    model = port_model(arch)
    psh = rules.param_sharding(pmesh, model, mode="train")
    state = AdamW(AdamWConfig()).init(model.parameters())
    po = rules.opt_state_sharding(pmesh, psh, state)
    assert po["step"] == tuple(jo["step"].spec) == ()
    names = [n for n, _ in model.named_parameters()]
    for moment in ("m", "v"):
        want = jax_param_specs(arch, jo[moment])
        for name, spec, t in zip(names, po[moment], state[moment]):
            assert spec == padded(want[name], t.ndim), (moment, name)


LOGICAL = [(("dp", None, "tp", None), (8, 64, 32, 128)),
           (("dp", None, "tp", None), (8, 64, 8, 128)),
           (("dp", "tp", None, None), (1, 32, 4096, 4096)),
           (("dp", None, None), (256, 4096, 5120)),
           (("dp", None, "tp"), (3, 7, 48)),
           (("tp", "dp"), (32, 32)),
           (("dp", "dp"), (512, 512)),
           ((None, "tp"), (5, 16))]


@pytest.mark.parametrize("mesh", list(MESHES) + ["1x1", "4x1"])
def test_resolve_equals_repro(mesh):
    shape, axes = MESHES.get(mesh, (tuple(int(s) for s in mesh.split("x")),
                                    ("data", "model")))
    jmesh, pmesh = JaxAbstractMesh(shape, axes), AbstractMesh(shape, axes)
    for logical, dims in LOGICAL:
        want = padded(jctx._resolve(jmesh, logical, dims), len(dims))
        assert context.resolve(pmesh, logical, dims) == want, (logical, dims)
    assert dp_axes(pmesh) == tuple(a for a in axes if a != "model")
    assert tp_axis(pmesh) == "model"


def test_sharding_rules_divisibility_fallback():
    """tests/test_infra.py:124-135's case: odd dims replicate, no raise."""
    mesh = AbstractMesh((1, 1), ("data", "model"))
    specs = rules.param_sharding(mesh, {"blocks.0.attn.w_q": (8, 16),
                                        "embed": (100, 8)})
    assert specs == {"blocks.0.attn.w_q": ("data", "model"),
                     "embed": ("model", "data")}
    odd = rules.param_sharding(AbstractMesh((3, 5), ("data", "model")),
                               {"blocks.0.attn.w_q": (8, 16),
                                "embed": (100, 8)})
    assert odd == {"blocks.0.attn.w_q": (None, None),
                   "embed": ("model", None)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_specs_equal_repro(arch):
    assert {k: (v.name, v.kind, v.seq_len, v.global_batch)
            for k, v in SHAPES.items()} == {
        k: (v.name, v.kind, v.seq_len, v.global_batch)
        for k, v in JAX_SHAPES.items()}
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for name in SHAPES:
        ok = supports_shape(cfg, SHAPES[name])
        assert ok == jax_supports_shape(jcfg, JAX_SHAPES[name])
        if SHAPES[name].kind == "decode":
            if not ok[0]:
                continue
            jd = jax_decode_specs(jcfg, JAX_SHAPES[name])
            pd = decode_specs(cfg, SHAPES[name])
            assert pd["pos"] == jd["pos"]
            assert tuple(pd["tokens"].shape) == jd["tokens"].shape
            assert str(pd["tokens"].dtype).removeprefix("torch.") == \
                str(jd["tokens"].dtype)
            for c, jc in zip(pd["cache"], jd["cache"]):
                for k in c:
                    assert tuple(c[k].shape) == jc[k].shape, (name, k)
                    assert str(c[k].dtype).removeprefix("torch.") == \
                        str(jc[k].dtype), (name, k)
                    assert c[k].device.type == "meta"
        else:
            jb = jax_batch_specs(jcfg, JAX_SHAPES[name])
            pb = batch_specs(cfg, SHAPES[name])
            assert set(jb) == set(pb)
            for k in jb:
                assert tuple(pb[k].shape) == jb[k].shape, (name, k)
                assert str(pb[k].dtype).removeprefix("torch.") == \
                    str(jb[k].dtype), (name, k)


def test_per_rank_param_bytes_equal_repro():
    """mistral-nemo-12b train_4k on 16x16: the bytes a rank holds under the
    port's specs equal the sum over `repro`'s."""
    arch = "mistral-nemo-12b"
    jmesh, pmesh = meshes("16x16")
    jp = jax_params(arch)
    jsh = jrules.param_sharding(jmesh, jp, mode="train")
    want = 0
    for leaf, sh in zip(jax.tree.leaves(jp), jax.tree.leaves(
            jsh, is_leaf=lambda x: hasattr(x, "spec"))):
        n = 1
        for dim, axes in zip(leaf.shape, padded(sh.spec, leaf.ndim)):
            n *= dim // rules._axes_size(pmesh, axes)
        want += n * leaf.dtype.itemsize
    model = port_model(arch)
    specs = rules.param_sharding(pmesh, model, mode="train")
    got = sum(rules.spec_bytes(p.shape, p.dtype, specs[n], pmesh)
              for n, p in model.named_parameters())
    assert got == want
    assert got < sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 200


def test_activation_mesh_prices_strided_candidates_only_inside():
    """`activation_mesh` installs its plain price of DTensor's strided
    candidates on entry and puts torch's own back on exit, nested too."""
    from torch.distributed.tensor import _ops
    torch_cost = _ops.utils.redistribute_cost
    mesh = AbstractMesh((1, 2), ("data", "model"))
    with context.activation_mesh(mesh):
        inside = _ops.utils.redistribute_cost
        assert inside is not torch_cost
        with context.activation_mesh(mesh):
            assert _ops.utils.redistribute_cost._repro_full is torch_cost
            assert context.current_mesh() is mesh
        assert _ops.utils.redistribute_cost is inside
    assert _ops.utils.redistribute_cost is torch_cost
    assert context.current_mesh() is None


def test_sharded_batch_and_restore_need_an_installed_mesh(tmp_path):
    """global_batch_to_device(sharding=) and restore(shardings=) read the
    mesh that `activation_mesh` installed, and raise without one."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import restore, save
    from repro_torch.data.pipeline import global_batch_to_device
    with pytest.raises(ValueError, match="activation_mesh"):
        global_batch_to_device({"tokens": np.zeros((2, 4), np.int32)},
                               {"tokens": ("data", None)}, device="cpu")
    save(str(tmp_path), 1, [torch.zeros(2)])
    with pytest.raises(ValueError, match="activation_mesh"):
        restore(str(tmp_path), [torch.zeros(2)], device="cpu",
                shardings=[(None,)])
    out, step = restore(str(tmp_path), [torch.zeros(2)], device="cpu")
    assert step == 1 and torch.equal(out[0], torch.zeros(2))
