"""driver_ms_per_iter.trajopt: milliseconds an iteration spends outside its
forward and backward: the Adam step, the motion-limit projection and the
driver's bookkeeping (TrajOptDriver.iteration's wall_time - forward_s -
backward_s, synchronized wall seconds of the program), over the units run
outside the profiler. Moves trajopt_steps_per_s."""
from benchmark.metrics._common import mean


def read(rec):
    return mean(1e3 * (u["wall_time"] - u["forward_s"] - u["backward_s"])
                for u in rec.timed_units())
