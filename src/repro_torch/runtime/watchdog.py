"""Straggler detection and liveness: step watchdog and fleet heartbeats
(``repro.runtime.watchdog``, copied: host-only Python).

A slow host shows up as a step-time outlier. The watchdog keeps an EWMA of
step time; a step exceeding ``threshold x`` the EWMA triggers the
``on_straggle`` callback and ticks a counter.

Every ``stop()`` also heartbeats through the global metrics registry
(``repro_torch.obs``): the step time lands in a gauge whose ``updated_at``
timestamp is the liveness signal (``time.time() - updated_at`` staleness =
a wedged step loop), the EWMA in a second gauge, and straggle events tick
a counter. ``name`` prefixes the metric names so several loops coexist in
the registry.

``HeartbeatMonitor`` is the fleet-level consumer of those beats: one
last-beat timestamp per machine, and a machine whose beat goes stale past
the timeout is declared dead EXACTLY ONCE (``newly_dead``) — the serving
failover path keys recovery off that declaration, so a flapping poll loop
can never trigger a second recovery of the same machine.
"""
from __future__ import annotations

import time

from repro_torch.obs import get_metrics


class StepWatchdog:
    def __init__(self, threshold: float = 3.0, ewma: float = 0.9,
                 warmup_steps: int = 3, on_straggle=None,
                 name: str = "watchdog"):
        self.threshold = threshold
        self.ewma_coef = ewma
        self.warmup = warmup_steps
        self.on_straggle = on_straggle
        self.name = name
        self.avg = None
        self.count = 0
        self.events: list[dict] = []
        self._t0 = None
        m = get_metrics()
        self._beat = m.gauge(f"{name}/step_s")
        self._avg_gauge = m.gauge(f"{name}/ewma_s")
        self._straggles = m.counter(f"{name}/straggles")

    @property
    def last_beat(self) -> float | None:
        """Wall-clock (``time.time()``) of the last completed step — the
        heartbeat timestamp liveness checks compare against now."""
        return self._beat.updated_at

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int):
        dt = time.monotonic() - self._t0
        self._beat.set(dt)
        self.count += 1
        if self.count <= self.warmup:
            self.avg = dt if self.avg is None else max(self.avg, dt)
            self._avg_gauge.set(self.avg)
            return dt
        if dt > self.threshold * self.avg:
            ev = {"step": step, "dt": dt, "avg": self.avg}
            self.events.append(ev)
            self._straggles.inc()
            if self.on_straggle:
                self.on_straggle(ev)
        self.avg = self.ewma_coef * self.avg + (1 - self.ewma_coef) * dt
        self._avg_gauge.set(self.avg)
        return dt


class HeartbeatMonitor:
    """Dead-machine detection over per-machine heartbeats.

    Each fleet member calls ``beat(machine)`` once per completed step (the
    serving loop's analogue of the ``sched/step_s`` watchdog beat — a
    ``BridgeScheduler`` given ``monitor=``/``machine=`` beats here from its
    drain loop). ``newly_dead(now)`` returns the machines whose last beat
    is staler than ``timeout`` that have NOT been declared before: one
    missed beat past the deadline marks the machine dead, exactly once.
    Recovery code keys off ``newly_dead``; ``dead`` is the cumulative set.

    ``now`` defaults to wall clock (``time.monotonic()``), but both
    ``beat`` and ``newly_dead`` take an explicit ``now`` so deterministic
    drills can run on a logical clock (the failover workload passes the
    step index; tests pass literals). Beats also land in per-machine
    ``{name}/machine{i}/beat`` gauges and declarations tick the
    ``{name}/dead_machines`` counter, so liveness is readable from one
    ``obs.snapshot()`` like every other signal here.
    """

    def __init__(self, machines=(), *, timeout: float = 1.5,
                 name: str = "fleet"):
        self.timeout = timeout
        self.name = name
        self.last: dict = {}
        self.declared: set = set()
        self._m = get_metrics()
        self._dead_counter = self._m.counter(f"{name}/dead_machines")
        for machine in machines:
            self.last[machine] = None  # known, not yet beating

    def beat(self, machine, now: float | None = None):
        if machine in self.declared:
            return  # a declared-dead machine's stale beat must not resurrect
        now = time.monotonic() if now is None else now
        self.last[machine] = now
        self._m.gauge(f"{self.name}/machine{machine}/beat").set(now)

    @property
    def dead(self) -> frozenset:
        """Machines declared dead so far (cumulative)."""
        return frozenset(self.declared)

    def newly_dead(self, now: float | None = None) -> tuple:
        """Declare (once) every machine whose beat missed the deadline.

        A machine that registered but never beat is dead once ``now``
        exceeds the timeout from its registration... which we cannot know —
        so never-beaten machines are only declared after their first beat
        goes stale; register-then-beat immediately in loops that care.
        """
        now = time.monotonic() if now is None else now
        out = []
        for machine, last in sorted(self.last.items()):
            if machine in self.declared or last is None:
                continue
            if now - last > self.timeout:
                self.declared.add(machine)
                self._dead_counter.inc()
                out.append(machine)
        return tuple(out)
