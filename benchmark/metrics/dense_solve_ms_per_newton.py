"""dense_solve_ms_per_newton.trajopt: milliseconds a forward Newton
iteration spends in the dense solve: engine/solver.solve_dense (the
assembled Hessian, elements.dense_hessian, and cuSOLVER's LU) and the eigh
SPD projection (ops/spd.project_psd), from the benchmark's spans waited
for on the card, inside the driver's forward; None where the scene takes
no dense solve. Moves trajopt_steps_per_s."""
from benchmark.metrics._common import ms_per_newton

SPANS = [("thinshelllab_torch.engine.solver", "solve_dense", "solve_dense"),
         ("thinshelllab_torch.ops.spd", "project_psd", "project_psd")]


def read(rec):
    return ms_per_newton(rec, ["solve_dense", "project_psd"], "forward")
