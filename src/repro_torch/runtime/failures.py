"""Failure injection for the restart and failover paths
(``repro.runtime.failures``, copied: host-only Python).

Two failure shapes:

* ``maybe_fail(step)`` — raise a simulated host failure at a chosen step,
  for a training loop's restart path (not ported yet).

* ``killed_machines(step)`` — per-machine kill schedules for the serving
  failover path: ``kill_schedule={machine: step}`` declares which machines
  die and when. ``core.merge.simulate_failover_host`` polls it at every
  merge phase boundary, and ``launch.failover.serve_failover`` at every
  serve step; a killed machine stops heartbeating and its in-memory state
  is gone.

Every injected failure — raised or kill — ticks the global
``failures/injected`` counter (``repro_torch.obs``), so a drill can confirm
from one ``obs.snapshot()`` that the failures it scheduled actually fired.
"""
from __future__ import annotations

from repro_torch.obs import get_metrics


class SimulatedFailure(RuntimeError):
    pass


class FailureInjector:
    def __init__(self, fail_at_steps: set[int] | None = None,
                 kill_schedule: dict[int, int] | None = None):
        self.fail_at = set(fail_at_steps or ())
        self.fired: set[int] = set()
        self.kill_at = dict(kill_schedule or {})
        self.killed: set[int] = set()
        self._counter = get_metrics().counter("failures/injected")

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            self._counter.inc()
            raise SimulatedFailure(f"injected host failure at step {step}")

    def killed_machines(self, step: int) -> tuple[int, ...]:
        """Machines whose scheduled kill step has arrived (``<= step``).
        Each kill fires exactly once (and ticks ``failures/injected``
        once), however often the same step is polled."""
        out = []
        for machine, at in sorted(self.kill_at.items()):
            if at <= step and machine not in self.killed:
                self.killed.add(machine)
                self._counter.inc()
                out.append(machine)
        return tuple(out)
