"""Share of a host thread's wall time in its hot spans that it spent off
the CPU (waiting for the interpreter lock, or preempted), in %:
(wall - thread CPU) / wall, summed over

- ``.open``: the collector thread's ``queue.cycle`` spans, with the
  ``engine.fetch`` spans inside them (the host blocked on the card) taken
  out of both sums;
- ``.train``: the training loop's ``step.forward``, ``step.reduce`` and
  ``step.optimizer`` spans, the phases the loop's thread runs itself.
  ``step.backward`` is left out: on the card autograd runs the backward on
  its own device thread while the loop's thread waits (the span's CPU share
  read 0.018 on an H100), which is no loss of the CPU to another thread.

A run has queue cycles or training steps, not both; the reader takes
whichever it finds."""

from port_bench import spans as program

STEP_PHASES = ("step.forward", "step.reduce", "step.optimizer")


def read(rec):
    r = program.records()
    if r is None:
        return None
    spans = r[0]
    cycles = [s for s in spans if s.name == "queue.cycle"]
    if cycles:
        ids = {s.cycle for s in cycles}
        fetches = [s for s in spans if s.name == "engine.fetch" and s.cycle in ids]
        wall = sum(map(program.duration_ns, cycles)) - sum(map(program.duration_ns, fetches))
        cpu = sum(s.cpu_ns for s in cycles) - sum(s.cpu_ns for s in fetches)
    else:
        steps = [s for s in spans if s.name in STEP_PHASES]
        wall, cpu = sum(map(program.duration_ns, steps)), sum(s.cpu_ns for s in steps)
    return 100.0 * (wall - cpu) / wall if wall > 0 else None
