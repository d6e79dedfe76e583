"""Cluster-scale example on the PyTorch port: the full MuxFlow control plane
on a simulated GPU cluster — matching-based scheduling, SysMonitor eviction,
mixed error handling, checkpoint/restart — against the paper's baselines,
then a full control-plane scenario (heterogeneous fleet, fault campaign,
node agents, autoscaling) through `repro_torch.cluster`.

  PYTHONPATH=src python examples/torch_cluster_sim.py [--device cpu]

The port of `examples/cluster_sim.py`: the same runs and printed lines.
The speed predictors train, and `muxflow-measured`'s speed matrix is
built, on the CUDA card (or on the CPU with ``--device cpu``).  `main`'s
keyword arguments size the runs and choose the policies (the defaults are
the original's: all ten at 200 devices over 8 h of trace C, then
`diurnal-mixed` on the same devices for 4 h; the tick, the trace and
the seed are the original's constants).  It returns each policy's
SimResults and the campaign's report.
"""
import argparse

from repro_torch.api import (build_speed_predictor, resolve,
                             run_policy_scenario, run_scenario)

POLICIES = ("online-only", "muxflow", "muxflow-s", "muxflow-m",
            "muxflow-s-m", "pb-time-sharing", "time-sharing",
            "tally-priority", "static-partition", "muxflow-measured")


def main(*, n_devices: int = 200, hours: float = 8.0, policies=POLICIES,
         campaign_hours: float = 4.0, device=None) -> dict:
    print("training speed predictor...")
    pred = build_speed_predictor(gpu_types=("T4", "A10"), n=1200, epochs=50,
                                 device=device)
    cfg = dict(n_devices=n_devices, horizon_s=hours * 3600.0, tick_s=60.0,
               trace="C", seed=0)
    print(f"simulating {hours:g}h on {n_devices} GPUs, trace C...\n")
    header = (f"{'policy':18s} {'online slow':>11s} {'p99 ms':>8s} "
              f"{'avg JCT':>9s} {'done':>9s} {'oversold':>8s} "
              f"{'util':>5s} {'evict%':>6s} {'err prop':>8s}")
    print(header)
    print("-" * len(header))
    rows = {}
    for pol in policies:
        p = resolve(pol).on_device(device)
        use = None
        if p.needs_predictor:
            # the measured policy trains its own predictor on profiled pairs
            # (SharingPolicy.build_predictor); everything else shares the
            # synthetic one built above
            use = (p.build_predictor(("T4", "A10"), samples=600, epochs=20,
                                     device=device)
                   if pol == "muxflow-measured" else pred)
        r = run_policy_scenario(p, use, device=device, **cfg)
        rows[pol] = r
        print(f"{pol:18s} {r.avg_slowdown:>10.3f}x {r.p99_latency_ms:>8.1f} "
              f"{r.avg_jct_s/60:>7.1f}mn {r.n_finished:>4d}/{r.n_jobs:<4d} "
              f"{r.oversold_gpu:>8.3f} {r.gpu_util:>5.2f} "
              f"{100*r.eviction_frac:>5.1f}% {r.errors_propagated:>3d}/{r.errors_injected:<3d}")
    print("\nMuxFlow: highest oversold GPU at <20% online slowdown, "
          "zero error propagation (graceful exit).")

    print(f"\nfull control-plane campaign: diurnal-mixed on "
          f"{n_devices} devices, {campaign_hours:g}h")
    rep = run_scenario("diurnal-mixed", device=device, n_devices=n_devices,
                       hours=campaign_hours, seed=0)
    s, j, f, a = rep["sim"], rep["jobs"], rep["faults"], rep["agents"]
    print(f"  jobs     : {j['completed']}/{j['n_jobs']} done, "
          f"{j['total_preemptions']} preemptions, "
          f"avg queue wait {j['avg_queue_wait_s']:.0f}s, "
          f"lost work {j['total_lost_work_s']:.0f}s")
    print(f"  faults   : {f['injected']} injected, {f['propagated']} "
          f"propagated (rate {f['propagation_rate']:.3f})")
    print(f"  agents   : {a['reports_dropped']} heartbeats dropped, "
          f"{a['stale_episodes']} stale episodes")
    print(f"  autoscale: {rep['autoscaler']['n_decisions']} decisions")
    print(f"  events   : {rep['events']['n_events']} "
          f"(digest {rep['events']['digest'][:12]}...)")
    print(f"  pools    : " + ", ".join(
        f"{p['pool']}={p['n']}" for p in rep["pools"]))
    return {"rows": rows, "campaign": rep}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(device=ap.parse_args().device)
