"""fwd_ms_per_step.trajopt: forward milliseconds a simulated step
(TrajOptDriver.iteration's forward_s over its steps: contacts, Newton,
velocity and plasticity), over the units run outside the profiler. Moves
trajopt_steps_per_s."""


def read(rec):
    units = rec.timed_units()
    steps = sum(u["steps"] for u in units)
    return 1e3 * sum(u["forward_s"] for u in units) / steps \
        if steps else None
