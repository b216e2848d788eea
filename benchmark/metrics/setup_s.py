"""setup_s: seconds from the run's start (before torch is imported) to the
window's opening: the CUDA start, the kernels' libraries (built on a
checkout's first run), the scene's build, its move to the card and the
warm-up units, which the output check then follows. Host clock."""


def read(rec):
    return rec.setup_s
