"""The port's dry-run layer: `launch.trace_analysis` (per-device flops,
bytes and collectives of the ops each rank runs), `launch.dryrun`'s cells
on the production mesh over a fake process group, and `launch.report`
against `repro`'s rendering of the same records."""
import json

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.trace_analysis import trace
from repro_torch.sharding.rules import distribute


@pytest.fixture
def fake_world():
    """A fake process group of the asked size, destroyed afterwards (other
    tests in this process must find none)."""
    def make(n):
        dryrun.fake_group(n)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def test_chained_matmul_flops():
    """N chained (B, D) @ (D, D) count 2*B*D*D*N dot flops
    (tests/test_infra.py:138-160's count)."""
    N, B, D = 6, 16, 32
    x, ws = torch.ones(B, D), torch.ones(N, D, D)

    def chain(x, ws):
        for i in range(N):
            x = torch.tanh(x @ ws[i])
        return x.sum()

    _, st = trace(chain, x, ws)
    assert st.flops == 2 * B * D * D * N
    assert st.elementwise_flops >= N * B * D       # the tanh outputs
    assert st.bytes_accessed > 0 and st.collective_bytes == 0


def test_collective_bytes_follow_the_ring(fake_world):
    """On a fake 8-rank group each functional collective counts its
    result's bytes times hlo_analysis.py:15-19's ring factor."""
    import torch.distributed._functional_collectives as funcol
    fake_world(8)
    n, g = 8, dist.group.WORLD
    x = torch.ones(64, 32)
    B = x.numel() * 4

    def run():
        funcol.all_reduce(x, "sum", g).wait()
        funcol.all_gather_tensor(x, 0, g).wait()
        funcol.reduce_scatter_tensor(x, "sum", 0, g).wait()
        funcol.all_to_all_single(x, None, None, g).wait()

    _, st = trace(run)
    want = {"all-reduce": 2 * (n - 1) / n * B,
            "all-gather": (n - 1) / n * n * B,
            "reduce-scatter": (n - 1) * B / n,
            "all-to-all": (n - 1) / n * B}
    assert st.collective_count == 4
    for name, b in want.items():
        assert st.collective_breakdown[name] == pytest.approx(b), name
    assert st.collective_bytes == pytest.approx(sum(want.values()))


def test_sharded_matmul_counts_each_device_share(fake_world):
    """A (256, 512) @ (512, 512) split 8 ways over its rows counts 1/8 of
    the global flops on a device; replicated, all of them."""
    fake_world(8)
    mesh = make_mesh((8,), ("data",), device="cpu")
    x = torch.ones(256, 512, device="meta")
    w = torch.ones(512, 512, device="meta")
    glob = 2 * 256 * 512 * 512
    xs = distribute(x, mesh, ("data", None), src_data_rank=None)
    wr = distribute(w, mesh, (None, None), src_data_rank=None)
    _, st = trace(lambda: xs @ wr)
    assert st.flops == glob // 8
    xr = distribute(x, mesh, (None, None), src_data_rank=None)
    _, st = trace(lambda: xr @ wr)
    assert st.flops == glob


def test_decode_cell_ok(fake_world):
    """tests/test_distribution.py:91-104's cell: xlstm-350m decode_32k on
    the 16x16 mesh."""
    rec = dryrun.run_cell("xlstm-350m", "decode_32k")
    assert rec["status"] == "ok", rec
    assert rec["terms"]["memory_s"] > 0
    assert rec["trace"]["dot_flops"] > 0
    assert rec["memory"]["peak_device_bytes"] > rec["memory"]["argument_bytes"]


def test_mistral_decode_gathers_no_cache(fake_world):
    """mistral-nemo-12b decode_32k: its 8 KV heads do not divide the
    16-way model axis, so the cache splits along its sequence; the largest
    all-gather of the step is smaller than one layer's local cache shard
    (no cache is gathered)."""
    from repro_torch.configs import SHAPES, decode_specs, get_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.sharding import cache_sharding
    rec = dryrun.run_cell("mistral-nemo-12b", "decode_32k")
    assert rec["status"] == "ok", rec
    cache = decode_specs(get_config("mistral-nemo-12b"),
                         SHAPES["decode_32k"])["cache"]
    spec = cache_sharding(AbstractMesh((16, 16), ("data", "model")), cache)
    assert spec[0]["k"] == (None, "data", "model", None, None)
    R, B, S, Hk, d = cache[0]["k"].shape
    layer_shard = (B // 16) * (S // 16) * Hk * d * 2
    largest = rec["trace"]["collective_largest"].get("all-gather", 0)
    assert largest < layer_shard


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_ssm_mixers_gather_no_activation(fake_world, arch):
    """The mLSTM (xlstm-350m: 4 heads on a 16-way model axis, so a head
    spans 4 ranks) and Mamba (jamba-1.5-large-398b) prefill mixers at FULL
    width, traced as rank 0 of (1, 16): no all-gather is an eighth the
    size of the up- or in-projection's output, so neither it nor q, k and
    v (a quarter each) is gathered whole on a rank, and the rank's matmul
    flops are under an eighth of one device's, so no rank runs the
    others' cells.  (The mLSTM's q, k and v weights, 8 MB each, are
    resharded between their dims, which a CPU mesh does by gathering: an
    all_to_all on the card.)"""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.sharding import activation_mesh, param_sharding
    from repro_torch.sharding.rules import distribute_params
    fake_world(16)
    mesh = make_mesh((1, 16), ("data", "model"), device="cpu")
    cfg = get_config(arch)
    mamba = arch.startswith("jamba")
    kind, mixer = ((ssm.Mamba, ssm.mamba_mixer) if mamba
                   else (ssm.MLSTM, ssm.mlstm_mixer))
    B, S = (1, 32) if mamba else (1, 16384)
    x = torch.empty((B, S, cfg.d_model), dtype=cfg.dtype, device="meta")
    one = kind(cfg, "meta")
    with torch.no_grad():
        _, st1 = trace(lambda: mixer(one, x, cfg))
        with activation_mesh(mesh):
            mix = kind(cfg, "meta")
            distribute_params(mix, mesh, param_sharding(mesh, mix,
                                                        mode="train"),
                              src_data_rank=None)
            xd = distribute(x, mesh, (None, None, None), src_data_rank=None)
            _, st = trace(lambda: mixer(mix, xd, cfg))
    proj = (mix.in_proj if mamba else mix.up_proj).shape[1]
    eighth = B * S * proj * cfg.dtype.itemsize // 8
    assert st.collective_breakdown.get("all-to-all", 0) > 0
    assert st.collective_largest.get("all-gather", 0) < eighth
    assert st.flops < st1.flops / 8


def test_report_rows_equal_repro(tmp_path, monkeypatch):
    """The port's tables against `repro`'s rendering of the same records
    (its keys `hlo` and `compile_s` for the port's `trace` and `trace_s`),
    line for line but the hardware line."""
    from repro.launch import report as jreport
    recs = [
        {"arch": "gemma-7b", "shape": "decode_32k", "variant": "base",
         "mesh": "16x16", "status": "ok", "trace_s": 3.2,
         "memory": {"peak_device_bytes": 5 * 2**30},
         "trace": {"dot_flops": 3e11, "bytes": 7e10, "collective_bytes": 2e9,
                   "collective_breakdown": {"all-reduce": 1.5e9,
                                            "all-gather": 5e8}},
         "terms": {"compute_s": 1e-3, "memory_s": 2e-2, "collective_s": 4e-3},
         "dominant": "memory", "model_flops": 1.2e11, "useful_ratio": 0.4,
         "roofline_fraction": 0.31},
        {"arch": "granite-moe-1b-a400m", "shape": "train_4k",
         "variant": "base", "mesh": "16x16", "status": "ok", "trace_s": 21.0,
         "memory": {"peak_device_bytes": 29 * 2**30},
         "trace": {"dot_flops": 2.9e13, "bytes": 3e12, "collective_bytes": 2e11,
                   "collective_breakdown": {"all-to-all": 1e11,
                                            "all-reduce": 6e10,
                                            "all-gather": 3e10,
                                            "reduce-scatter": 1e10}},
         "terms": {"compute_s": 0.03, "memory_s": 0.9, "collective_s": 1.4},
         "dominant": "collective", "model_flops": 2e13, "useful_ratio": 0.7,
         "roofline_fraction": 0.015},
        {"arch": "gemma-7b", "shape": "long_500k", "variant": "base",
         "mesh": "16x16", "status": "skipped", "reason": "quadratic"},
        {"arch": "gemma-7b", "shape": "train_4k", "variant": "base",
         "mesh": "2x16x16", "status": "ok", "trace_s": 19.5,
         "memory": {"peak_device_bytes": 151 * 2**30},
         "trace": {"dot_flops": 1.9e15, "bytes": 8.7e12,
                   "collective_bytes": 1.3e12,
                   "collective_breakdown": {"all-gather": 1e12}},
         "terms": {"compute_s": 1.9, "memory_s": 2.6, "collective_s": 2.9},
         "dominant": "collective", "model_flops": 1.5e15,
         "useful_ratio": 0.8, "roofline_fraction": 0.08}]
    ours, theirs = tmp_path / "port", tmp_path / "repro"
    ours.mkdir()
    theirs.mkdir()
    for r in recs:
        name = f"{r['arch']}__{r['shape']}__{r['mesh']}.json"
        (ours / name).write_text(json.dumps(r))
        j = dict(r)
        if "trace" in j:
            j["hlo"], j["compile_s"] = j.pop("trace"), j.pop("trace_s")
        (theirs / name).write_text(json.dumps(j))
    monkeypatch.setattr(jreport, "OUT_DIR", str(theirs))
    for mesh in ("16x16", "2x16x16"):
        assert report.dryrun_section(mesh, str(ours)) == \
            jreport.dryrun_section(mesh)
    got = report.roofline_section(str(ours)).splitlines()
    want = jreport.roofline_section().splitlines()
    assert "H100" in got[0] and "v5e" in want[0]
    assert got[1:] == want[1:]
    assert len(got) == 2 + 2 + 2            # header, blank, rule, two rows
