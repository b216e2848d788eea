"""element_ms_per_newton.trajopt: milliseconds a forward Newton iteration
spends in engine/elements.all_groups (element energies, gradients and
AD Hessians), less the eigh projection nested in it (ops/spd.project_psd,
the dense-solve layer's), from the benchmark's spans waited for on the
card, inside the driver's forward. Moves trajopt_steps_per_s."""
from benchmark.metrics._common import ms_per_newton

SPANS = [("thinshelllab_torch.engine.elements", "all_groups", "all_groups"),
         ("thinshelllab_torch.ops.spd", "project_psd", "project_psd")]


def read(rec):
    return ms_per_newton(rec, ["all_groups"], "forward",
                         minus=["project_psd"])
