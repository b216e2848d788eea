"""The native topology helpers of the frozen copy: none. Every function
returns None, so core/topology.py and core/builder.py take their numpy
paths (the port's TSL_NO_NATIVE=1 route)."""


def cloth_mesh_tables(N, M):
    return None


def build_hinges(f2v, cf, cp, init_pos):
    return None


def cube_tets(nx, ny, nz):
    return None
