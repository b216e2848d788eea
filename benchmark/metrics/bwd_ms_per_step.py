"""bwd_ms_per_step.trajopt: adjoint milliseconds a simulated step
(TrajOptDriver.iteration's backward_s over its steps: the seed loss and
engine/adjoint.backward with its solves), over the units run outside the
profiler. Moves trajopt_steps_per_s."""


def read(rec):
    units = rec.timed_units()
    steps = sum(u["steps"] for u in units)
    return 1e3 * sum(u["backward_s"] for u in units) / steps \
        if steps else None
