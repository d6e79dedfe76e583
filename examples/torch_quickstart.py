"""Quickstart: the MuxFlow pipeline in one minute, on the PyTorch port.

1. build two workload classes from the model zoo (an online decoder and an
   offline trainer),
2. profile them, train the speed predictor (on the CUDA card, or on the
   CPU with ``--device cpu``),
3. run Algorithm 1 (dynamic SM + KM matching) to pair offline jobs with
   online-serving devices,
4. print the chosen sharing plan.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port of `examples/quickstart.py`: the same steps and printed lines.
`main` returns what it prints: the devices' lines, the plan and its total.
"""
import argparse

import numpy as np

from repro_torch.api import (OFFLINE_MODEL_PROFILES, OfflineJob, OnlineSlot,
                             build_speed_predictor, dynamic_sm,
                             online_profile, schedule)


def main(*, device=None) -> dict:
    print("== training the speed predictor (4-layer MLP, momentum SGD) ==")
    predictor = build_speed_predictor(gpu_types=("T4",), n=800, epochs=40,
                                      device=device)

    rng = np.random.default_rng(0)
    services = ["recommend", "translate", "vision"]
    slots, devices = [], []
    for i in range(6):
        qps = float(rng.uniform(15, 180))
        prof = online_profile(services[i % 3], qps)
        slots.append(OnlineSlot(i, "T4", prof))
        devices.append(f"  device {i}: {prof.name:10s} qps={qps:5.0f} "
                       f"sm_activity={prof.sm_activity:.2f} -> dynamic SM "
                       f"share for offline = "
                       f"{dynamic_sm(prof.sm_activity):.1f}")
        print(devices[-1])

    jobs = [OfflineJob(j, OFFLINE_MODEL_PROFILES[m], 3600.0)
            for j, m in enumerate(rng.choice(list(OFFLINE_MODEL_PROFILES), 4))]
    print("\n== Algorithm 1: KM matching over predicted normalized throughput ==")
    plan = schedule(slots, jobs, predictor)
    for a in plan:
        job = jobs[[j.job_id for j in jobs].index(a.job_id)]
        print(f"  GPU {a.device_id} <- offline '{job.profile.name}' "
              f"@ SM {a.sm_share:.0%}, predicted tput {a.predicted_tput:.2f}")
    total = sum(a.predicted_tput for a in plan)
    print(f"\n  plan total normalized throughput: {total:.2f}")
    return {"devices": devices,
            "plan": [(a.device_id, a.job_id, a.sm_share, a.predicted_tput)
                     for a in plan],
            "total": total}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(device=ap.parse_args().device)
