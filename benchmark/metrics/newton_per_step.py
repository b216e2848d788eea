"""newton_per_step.trajopt: Newton iterations a simulated step, the mean of
engine/solver.newton_solve's stats["newton_per_step"] over the window's
counted units. Moves trajopt_steps_per_s."""
from benchmark.metrics._common import flat, mean


def read(rec):
    return mean(flat(rec.units, "newton_per_step"))
