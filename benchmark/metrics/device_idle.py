"""device_idle.trajopt: the share (%) of the profiled unit in which no
operation ran on the card (torch.profiler's trace: 100 * (1 - busy_s /
window_s)). Moves trajopt_steps_per_s."""


def read(rec):
    d = rec.device
    if d is None or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
