"""Lifecycle traces: job spans from the EventBus, request spans from lanes.

Two tracers share one streaming :class:`TraceWriter`:

* :class:`EventBusTracer` subscribes to the control plane's bus and folds
  ``job_submit → job_start → job_finish/evict`` into one ``job_span`` row
  per placement segment (re-placements after requeue increment ``seg``),
  carrying queue-wait and completion/eviction attributes.  Every other
  event kind (errors, device failures, schedule rounds, autoscale
  decisions, agent staleness) passes through as a point ``event`` row in
  bus order.  Spans still open at ``finalize`` flush with ``end="open"``.
* :class:`RequestTracer` hangs off the serving plane's lanes and emits one
  ``request_batch`` row per continuous-batching drain (arrival→batch→
  complete with queue-age, batch-id, wait/service/latency attributes) and
  one ``request_shed`` row per admission shed.

Rows carry sim time only; ordering follows the deterministic bus/lane
sequence, so trace files are byte-identical across same-seed runs and
across tick engines.  No event objects are retained — a span's open state
is a small dict per in-flight job.

Performance contract: a flagship campaign streams ~10⁵ trace rows, so row
construction pre-rounds floats (:func:`~repro_torch.obs.export.rfloat`) and
writes through :meth:`~repro_torch.obs.export.JsonlWriter.write_flat`, skipping
the recursive canonicalization pass while producing identical bytes.

Copied from `repro/obs/trace.py` with the same behaviour.
"""
from __future__ import annotations

from repro_torch.obs.export import _NDIGITS, JsonlWriter, rfloat

TRACE_SCHEMA = "repro.obs.trace/v1"


class TraceWriter:
    """A kind-counting facade over :class:`JsonlWriter`.

    ``row`` takes ownership of ``fields`` (it is mutated and must be a flat
    dict of primitives with floats pre-rounded via :func:`rfloat` — the
    ``write_flat`` contract)."""

    def __init__(self, writer: JsonlWriter):
        self.writer = writer
        self.kinds: dict[str, int] = {}
        writer.write({"kind": "header", "schema": TRACE_SCHEMA})

    def row(self, kind: str, fields: dict) -> None:
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        fields["kind"] = kind
        self.writer.write_flat(fields)

    def close(self) -> None:
        self.writer.close()

    def summary(self) -> dict:
        return {"schema": TRACE_SCHEMA, "rows": self.writer.rows,
                "kinds": dict(sorted(self.kinds.items())),
                "digest": self.writer.digest()}


class EventBusTracer:
    """Folds bus events into job spans + point rows (see module doc).

    Matches on ``Event.kind.value`` strings (no import of the cluster
    package — the dependency points control-plane → obs only)."""

    def __init__(self, tw: TraceWriter):
        self.tw = tw
        self._submit: dict[int, float] = {}     # job -> queue-entry time
        self._open: dict[int, dict] = {}        # job -> open span fields
        self._segments: dict[int, int] = {}     # job -> placements so far

    def install(self, bus) -> None:
        bus.subscribe(self._on_event)

    # ------------------------------------------------------------- dispatch
    # Hot path: runs once per bus event (~2·10⁵ per flagship campaign).
    # ``ev.data`` tuples are scanned in place instead of dict()-ed, and
    # ``ev.t`` (always a plain float) is rounded inline.
    def _on_event(self, ev) -> None:
        k = ev.kind.value
        if k == "job_submit":
            self._submit[ev.job] = ev.t
            return
        if k == "job_start":
            model = share = None
            for dk, dv in ev.data:
                if dk == "model":
                    model = dv
                elif dk == "share":
                    share = dv
            seg = self._segments.get(ev.job, 0)
            self._segments[ev.job] = seg + 1
            t_sub = self._submit.pop(ev.job, None)
            t = round(ev.t, _NDIGITS) + 0.0
            self._open[ev.job] = {
                "job": ev.job, "seg": seg, "device": ev.device,
                "t_submit": None if t_sub is None
                else round(t_sub, _NDIGITS) + 0.0,
                "t_start": t,
                "queue_wait_s": (None if t_sub is None
                                 else round(ev.t - t_sub, _NDIGITS) + 0.0),
                "model": model, "share": rfloat(share)}
        elif k == "job_finish":
            span = self._open.pop(ev.job, None)
            if span is not None:
                jct = wall = None
                for dk, dv in ev.data:
                    if dk == "jct_s":
                        jct = dv
                    elif dk == "wall_s":
                        wall = dv
                span["t_end"] = round(ev.t, _NDIGITS) + 0.0
                span["end"] = "finish"
                span["jct_s"] = rfloat(jct)
                span["wall_s"] = rfloat(wall)
                self.tw.row("job_span", span)
        elif k == "job_evict":
            data = dict(ev.data)
            span = self._open.pop(ev.job, None)
            if span is not None:
                span.update(t_end=round(ev.t, _NDIGITS) + 0.0, end="evict",
                            reason=data.get("reason"),
                            requeued=data.get("requeued"),
                            progress_s=rfloat(data.get("progress_s")),
                            checkpoint_s=rfloat(data.get("checkpoint_s")))
                self.tw.row("job_span", span)
            if data.get("requeued"):
                # the requeued segment's queue wait starts at eviction
                self._submit[ev.job] = ev.t
        else:
            self.tw.row("event", {
                "event": k, "t": round(ev.t, _NDIGITS) + 0.0,
                "device": ev.device, "job": ev.job,
                "data": {dk: rfloat(dv) for dk, dv in ev.data}})

    def finalize(self, t_end: float) -> None:
        for job in sorted(self._open):
            span = self._open[job]
            span.update(t_end=None, end="open")
            self.tw.row("job_span", span)
        self._open.clear()


class RequestTracer:
    """Request-lifecycle spans from the serving lanes (see module doc).
    Attached via :meth:`ServingPlane.attach_tracer`; lanes call back per
    batch drain and per shed, in deterministic lane/tick order."""

    def __init__(self, tw: TraceWriter):
        self.tw = tw

    def batch(self, service: str, batch: int, t: float, t_enqueue: float,
              n: int, work: float, wait_ms: float, service_ms: float,
              lat_ms: float) -> None:
        self.tw.row("request_batch", {
            "service": service, "batch": batch, "t": rfloat(t),
            "t_enqueue": rfloat(t_enqueue),
            "queue_age_s": rfloat(t - t_enqueue), "n": n,
            "work": rfloat(work), "wait_ms": rfloat(wait_ms),
            "service_ms": rfloat(service_ms), "lat_ms": rfloat(lat_ms)})

    def shed(self, service: str, t: float, t_enqueue: float,
             n: int) -> None:
        self.tw.row("request_shed", {
            "service": service, "t": rfloat(t),
            "t_enqueue": rfloat(t_enqueue),
            "queue_age_s": rfloat(t - t_enqueue), "n": n})
