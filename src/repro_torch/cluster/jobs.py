"""Offline-job lifecycle: submit → queue → place → run → checkpoint →
preempt/migrate → requeue → complete.

The :class:`JobManager` is a pure observer of engine events (it never mutates
the simulator) that gives every offline job a legal state machine and the
checkpoint-restore cost model the engine's struct-of-arrays core does not
track per job: queue waits, placement counts, preemptions, work lost since
the last checkpoint, and the restart overhead (image pull + restore) paid on
every re-placement after a preemption.

Legality is enforced at transition time: placing a job that is already
RUNNING (double placement) or placing/finishing one that is COMPLETED
(run-after-complete) raises :class:`LifecycleError` in strict mode — the
subsystem tests run every scenario strict.

Copied from `repro/cluster/jobs.py` with the same behaviour.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.cluster.events import Event, EventBus, EventKind


class JobState(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"


class LifecycleError(RuntimeError):
    """An illegal job-lifecycle transition."""


@dataclasses.dataclass
class JobRecord:
    job_id: int
    model: str
    submit_s: float
    duration_s: float
    state: JobState = JobState.QUEUED
    device: int = -1
    placements: int = 0
    preemptions: int = 0
    queue_wait_s: float = 0.0          # total time spent QUEUED before runs
    lost_work_s: float = 0.0           # progress − checkpoint at evictions
    restore_overhead_s: float = 0.0    # modeled restart cost (re-placements)
    queued_at: float = 0.0
    completed_at: float | None = None
    jct_s: float | None = None


class JobManager:
    """Event-driven lifecycle tracker for every offline job in a scenario."""

    def __init__(self, bus: EventBus, *, restart_delay_s: float = 90.0,
                 strict: bool = True):
        self.bus = bus
        self.restart_delay_s = restart_delay_s
        self.strict = strict
        self.jobs: dict[int, JobRecord] = {}
        self.violations: list[str] = []
        for kind in (EventKind.JOB_SUBMIT, EventKind.JOB_START,
                     EventKind.JOB_FINISH, EventKind.JOB_EVICT):
            bus.subscribe(self._on_event, kind)

    # ------------------------------------------------------------ transitions
    def _illegal(self, msg: str) -> None:
        if self.strict:
            raise LifecycleError(msg)
        self.violations.append(msg)

    def _on_event(self, ev: Event) -> None:
        data = dict(ev.data)
        if ev.kind is EventKind.JOB_SUBMIT:
            if ev.job in self.jobs:
                self._illegal(f"job {ev.job} submitted twice")
                return
            self.jobs[ev.job] = JobRecord(
                job_id=ev.job, model=data.get("model", "?"),
                submit_s=ev.t, duration_s=data.get("duration_s", 0.0),
                queued_at=ev.t)
            return
        rec = self.jobs.get(ev.job)
        if rec is None:
            self._illegal(f"{ev.kind.value} for unknown job {ev.job}")
            return
        if ev.kind is EventKind.JOB_START:
            if rec.state is JobState.RUNNING:
                self._illegal(f"job {ev.job} double-placed "
                              f"(devices {rec.device} and {ev.device})")
                return
            if rec.state is JobState.COMPLETED:
                self._illegal(f"job {ev.job} placed after completion")
                return
            rec.queue_wait_s += ev.t - rec.queued_at
            rec.state = JobState.RUNNING
            rec.device = ev.device
            rec.placements += 1
            if rec.preemptions:
                # checkpoint-restore cost model: every re-placement after a
                # preemption pays image pull + restore before making progress
                rec.restore_overhead_s += self.restart_delay_s
        elif ev.kind is EventKind.JOB_EVICT:
            if rec.state is not JobState.RUNNING:
                self._illegal(f"job {ev.job} evicted while {rec.state.value}")
                return
            rec.device = -1
            requeued = bool(data.get("requeued", True))
            rec.lost_work_s += max(
                0.0, data.get("progress_s", 0.0) - data.get("checkpoint_s", 0.0))
            if requeued:
                rec.state = JobState.QUEUED
                rec.queued_at = ev.t
                rec.preemptions += 1
            else:
                # evicted past its duration: treat as completed-at-eviction
                rec.state = JobState.COMPLETED
                rec.completed_at = ev.t
                rec.jct_s = ev.t - rec.submit_s
        elif ev.kind is EventKind.JOB_FINISH:
            if rec.state is JobState.COMPLETED:
                self._illegal(f"job {ev.job} finished after completion")
                return
            if rec.state is not JobState.RUNNING:
                self._illegal(f"job {ev.job} finished while {rec.state.value}")
                return
            rec.state = JobState.COMPLETED
            rec.device = -1
            rec.completed_at = ev.t
            rec.jct_s = data.get("jct_s", ev.t - rec.submit_s)

    # --------------------------------------------------------------- queries
    def by_state(self) -> dict[str, int]:
        out = {s.value: 0 for s in JobState}
        for rec in self.jobs.values():
            out[rec.state.value] += 1
        return out

    def summary(self) -> dict:
        recs = list(self.jobs.values())
        done = [r for r in recs if r.state is JobState.COMPLETED]
        n = max(len(recs), 1)
        return {
            "n_jobs": len(recs),
            "by_state": self.by_state(),
            "completed": len(done),
            "avg_jct_s": (sum(r.jct_s or 0.0 for r in done) / len(done)
                          if done else 0.0),
            "avg_queue_wait_s": sum(r.queue_wait_s for r in recs) / n,
            "total_preemptions": sum(r.preemptions for r in recs),
            "max_preemptions": max((r.preemptions for r in recs), default=0),
            "total_placements": sum(r.placements for r in recs),
            "total_lost_work_s": sum(r.lost_work_s for r in recs),
            "total_restore_overhead_s": sum(r.restore_overhead_s
                                            for r in recs),
            "lifecycle_violations": len(self.violations),
        }
