"""Both packages' spatial-hash broadphase against the exhaustive sweep on
the 40k-triangle bench's initial positions, on the CPU.

    PYTHONPATH=. python scripts/probe_hash_oracle.py [cloth_N] [--f64]

Builds `bench_scene.make(cloth_N=..., table_n=12)` (140 by default: 39,200
cloth triangles a sheet, so its two cloth-source pairs take the hash) in
the JAX package and in thinshelllab_torch, projects the initial positions
with the hash and with the exhaustive dense sweep (top_k = max_src_faces)
in each, and prints, for each pair of projections: the found rows of the
hash pairs, the rows on another face, and the largest distance by which
the first projection's face is farther and nearer than the second's.
"""
import dataclasses
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import hash_compare, hash_rows  # noqa: E402
from thinshelllab_tpu.ops import collision as jcollision  # noqa: E402
from thinshelllab_tpu.scenes import bench_scene as jbench  # noqa: E402
from thinshelllab_torch.ops import collision  # noqa: E402
from thinshelllab_torch.scenes import bench_scene  # noqa: E402


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    N = int(args[0]) if args else 140
    f64 = "--f64" in sys.argv
    jdt, tdt = ((jnp.float64, torch.float64) if f64
                else (jnp.float32, torch.float32))
    jsc = jbench.make(cloth_N=N, table_n=12, dtype=jdt)
    con = dataclasses.replace(jsc.spec.contact, hash_min_faces=0)
    jspec = dataclasses.replace(jsc.spec, contact=con)
    joracle = dataclasses.replace(jspec, contact=dataclasses.replace(
        con, hash_desc=(None,) * len(con.hash_desc),
        top_k=con.max_src_faces))
    pos = np.asarray(jsc.state0.pos, np.float64 if f64 else np.float32)
    z = jnp.zeros((con.capacity,), jnp.int32)
    p = jnp.asarray(pos)
    vn = jcollision.vertex_normals(p, jspec.faces, jspec.NV)
    jh, jo = (jax.jit(lambda x, s=s: jcollision.projection_query(
        s, x, vn, z, z))(p) for s in (jspec, joracle))

    spec, s0, _ = bench_scene.make(cloth_N=N, table_n=12, dtype=tdt).to("cpu")
    spec = spec.replace(contact=spec.contact.replace(hash_min_faces=0))
    oracle = spec.replace(contact=spec.contact.replace(
        hash_desc=(None,) * len(con.hash_desc), top_k=con.max_src_faces))
    pt = torch.as_tensor(pos)
    vt = collision.vertex_normals(pt, spec.faces, spec.NV)
    zt = torch.zeros((con.capacity,), dtype=torch.int64)
    th, to = (collision.projection_query(s, pt, vt, zt, zt)
              for s in (spec, oracle))

    rows = hash_rows(spec.contact)
    p64 = pos.astype(np.float64)
    for label, a, b in (("JAX hash vs JAX exhaustive", jh, jo),
                        ("port hash vs port exhaustive", th, to),
                        ("port hash vs JAX hash", th, jh),
                        ("port exhaustive vs JAX exhaustive", to, jo)):
        a = [np.asarray(x) for x in a]
        b = [np.asarray(x) for x in b]
        fe, de, n, n_mis, farther, nearer = hash_compare(spec.contact, p64,
                                                         a, b, rows)
        print(f"{label}: found sets equal {fe}, directions equal {de}; {n} "
              f"found rows, {n_mis} on another face, farther by up to "
              f"{farther:.3e} m, nearer by up to {nearer:.3e} m")


if __name__ == "__main__":
    main()
