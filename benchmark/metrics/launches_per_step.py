"""launches_per_step.trajopt: operations on the card (kernels, copies, fills)
in the profiled unit's trace over its simulated steps. Moves
trajopt_steps_per_s."""


def read(rec):
    d = rec.device
    if d is None or not rec.traced_steps:
        return None
    return d["ops"] / rec.traced_steps
