"""trajopt_steps_per_s: the simulated steps of every trajopt iteration that
completed in the window, each through the forward and the adjoint, over
the seconds from the window's start to the end of the last of them. The
iteration in flight at the close is dropped. Host clock."""


def read(rec):
    return rec.window.rate()
