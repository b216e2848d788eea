"""The plain reference of a trajectory-optimisation iteration, written from
the model's definitions alone in plain PyTorch.

It shares with thinshelllab_torch only the scene's definition: the arrays
of rest shapes, masses, stencils, materials, contact pairs and the
gripper's pads come from the frozen copy of the scene builder in
`tslref/`, built from the configuration, and the reward and its adjoint
seed are the scene's. Everything that an iteration computes is worked out
here another way than the program works it out:

- The energy of a state is one scalar function of all positions. Its
  gradient and its Hessian are autograd's derivatives of that function.
  The program assembles per-element AD blocks, projects them to SPD and
  solves them by LU, or by CG on a DIA store.
- Newton minimises on the true Hessian, shifted where it is not positive
  definite, and stops at max |step| < 1e-12 m. The program stops at
  newton_tol x dt = 5e-10 m.
- The contact query tests each vertex against the pair's faces by a
  closest-point rule of its own.
- The adjoint solves the true Hessian directly. It takes each chain
  (inertia, friction pressure and rest offset, bending rest angle) as the
  derivative of the energy's gradient with respect to what that gradient
  depends on, by autograd.

The semantics are the upstream ThinShellLab's (BaseScene.time_step, the
analytic gradient of analytic_grad_single.py, optim.Adam,
traj_opt_single.fix_action), as the port states them:
- a time step moves the gripper, latches the contact side, minimises the
  incremental potential with that contact set, updates the velocity with
  damping and moves a hinge's rest angle to its yield surface;
- the backward sweep rebuilds each step's contact set at the step's start
  positions with the latch carried backwards, clamps the carried
  gradients to +-1000, passes the rest-angle gradient through plasticity
  with weight 1 where the hinge yielded and 0.1 elsewhere, and averages
  the pads' frozen-vertex gradients into the gripper's, clamped.

It runs in float64 on any device. Only single-pad-per-part grippers
("single" mode) are written out."""
from __future__ import annotations

import numpy as np
import torch

NEWTON_STEP_M = 1e-12   # Newton stops once max |step| falls below this
NEWTON_MAX = 200
R2_FLOOR = 1e-60        # |u|^2 floor of the friction slip's norm
TIE_M = 1e-12           # contact scores closer than this are a tie


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dot(a, b):
    return (a * b).sum(-1)


class Model:
    """A task scene's arrays on `device` in float64, and the scene's
    reward and adjoint seed."""

    def __init__(self, task, device):
        s, p = task.spec, task.params
        d = torch.float64
        self.device = device

        def f(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=d,
                                   device=device)

        def i(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.task = task
        self.NV = int(np.asarray(s.mass).shape[0])
        self.dt, self.damping = float(s.dt), float(s.damping)
        self.k_c, self.eps_c = float(s.k_contact), float(s.eps_contact)
        self.eh = float(s.eps_v) * self.dt
        self.plastic = bool(s.plastic)
        self.mass = f(s.mass)
        self.force = self.mass[:, None] * f(s.gravity) + f(s.ext_force)
        self.frozen = torch.as_tensor(np.asarray(s.frozen, bool),
                                      device=device)
        self.free = ~self.frozen.reshape(-1)
        self.unf = (~self.frozen).to(d)
        # cloth faces and hinges
        c = s.cloth
        cid = np.asarray(c.cloth_id)
        self.f2v, self.l0, self.area0 = i(c.f2v), f(c.l0), f(c.rest_area)
        self.kl = f(np.asarray(p.kl)[cid])
        self.ka = f(np.asarray(p.ka)[cid])
        hmask = np.asarray(c.hinge_mask, bool)
        hcl = np.asarray(c.hinge_cloth)
        self.NH = int(hmask.shape[0])
        self.hmask = torch.as_tensor(hmask, device=device)
        self.hon = i(np.nonzero(hmask)[0])
        on = np.nonzero(hmask)[0]
        self.hv = i(np.asarray(c.hinge_verts)[on])
        self.hsel = i(np.argmax(np.asarray(c.hinge_sel)[on], axis=-1))
        self.hcoef = f(np.asarray(c.hinge_coef)[on])
        self.kb = f(np.asarray(p.kb)[hcl[on]])
        self.k_angle = f(np.asarray(c.k_angle, np.float64)[hcl])
        # tetrahedra: (vertices, inverse rest matrix, volume, mu, lam)
        self.tets = []
        for soup, mu, lam, kind in ((s.neo, p.neo_mu, p.neo_lam, "neo"),
                                    (s.tact, p.tact_mu, p.tact_lam, "tact")):
            if np.asarray(soup.tets).shape[0]:
                g = np.asarray(soup.group)
                self.tets.append((kind, i(soup.tets), f(soup.B), f(soup.W),
                                  f(np.asarray(mu)[g]), f(np.asarray(lam)[g])))
        # contact query slots and pairs
        con = s.contact
        self.faces = i(s.faces)
        self.cq_vert = i(con.cq_vert)
        self.cq_mu = f(np.asarray(p.mu_pairs)[np.asarray(con.cq_mu_id)])
        self.capacity = int(con.capacity)
        self.pairs = [tuple(int(v) for v in pd[:4]) + (bool(pd[4]),)
                      for pd in con.pair_desc]
        self.top_k = int(con.top_k)
        self.cutoff = 2.0 * float(s.grid_h)
        # gripper
        g = s.gripper
        if g.mode not in ("single", "none"):
            raise NotImplementedError(f"gripper mode {g.mode}")
        self.g_mode, self.n_part = g.mode, int(g.n_part)
        self.pad_part = list(g.pad_part)
        bound = np.asarray(g.bound_idx, np.int64)
        self.bound_local = i(bound)
        self.bound_global = [i(int(off) + bound) for off in g.pad_offset]
        self.n_bound = int(g.n_bound)

    # ------------------------------------------------------------ state

    def initial(self):
        """The scene's initial state as a dict of float64 tensors."""
        s0 = self.task.state0
        d, dev = torch.float64, self.device

        def f(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=d,
                                   device=dev)

        gs = s0.gripper
        return {"pos": f(s0.pos), "vel": f(s0.vel), "ref": f(s0.ref_angle),
                "flag": torch.as_tensor(np.asarray(s0.proj_flag),
                                        device=dev),
                "dir": torch.as_tensor(np.asarray(s0.proj_dir), device=dev),
                "g_pos": f(gs.pos), "g_rot": f(gs.rot),
                "pad_local": f(gs.pad_local)}

    # ------------------------------------------------------------ geometry

    def hinge_angles(self, x):
        """Dihedral angle of every active hinge: the stencil [v0, v1, v2,
        v3] has the normals n1 = (v1 - v0) x (v2 - v1) and
        n2 = (a - v3) x (b - a), with a, b and the edge e = eb - ea picked
        by the stencil's selection rows; theta = atan2((n1 x n2) . e/|e|,
        n1 . n2)."""
        s = x[self.hv]                              # (H, 4, 3)
        pick = torch.gather(s, 1, self.hsel[..., None].expand(-1, -1, 3))
        n1 = _cross(s[:, 1] - s[:, 0], s[:, 2] - s[:, 1])
        n2 = _cross(pick[:, 0] - s[:, 3], pick[:, 1] - pick[:, 0])
        e = pick[:, 3] - pick[:, 2]
        e = e / e.norm(dim=-1, keepdim=True)
        return torch.atan2(_dot(_cross(n1, n2), e), _dot(n1, n2))

    @staticmethod
    def rotation(q):
        """Rotation matrices of unit quaternions (w, x, y, z)."""
        w, x, y, z = q.unbind(-1)
        return torch.stack([
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ], -1).reshape(q.shape[:-1] + (3, 3))

    def vertex_normals(self, x):
        """Per vertex: the sum of its faces' (p1 - p0) x (p2 - p0),
        normalised."""
        fc = self.faces
        n = _cross(x[fc[:, 1]] - x[fc[:, 0]], x[fc[:, 2]] - x[fc[:, 0]])
        vn = torch.zeros_like(x).index_add_(0, fc.reshape(-1),
                                            n.repeat_interleave(3, 0))
        return vn / vn.norm(dim=1, keepdim=True).clamp_min(1e-300)

    @staticmethod
    def closest(x, p):
        """Point x (..., 3) against triangles p (..., 3, 3): the distance
        and the barycentric weights of its closest point by the upstream
        rule (geometry.pt2tri): the projection into the plane, unless it
        lies outside an edge; then, for the first such edge in the order
        (p0 p1), (p1 p2), (p2 p0), the nearest point of that segment."""
        n = _cross(p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :])
        area2 = n.norm(dim=-1)
        nh = n / area2[..., None]
        w = torch.stack([_dot(_cross(p[..., (k + 1) % 3, :] - x,
                                     p[..., (k + 2) % 3, :] - x), nh)
                         for k in range(3)], -1) / area2[..., None]
        outside = [_dot(_cross(x - p[..., k, :],
                               p[..., (k + 1) % 3, :] - p[..., k, :]), nh) > 0
                   for k in range(3)]
        taken = torch.zeros_like(outside[0])
        for k in range(3):
            a, b = p[..., k, :], p[..., (k + 1) % 3, :]
            t = (_dot(x - a, b - a) / _dot(b - a, b - a)).clamp(0.0, 1.0)
            we = torch.zeros_like(w)
            we[..., k] = 1 - t
            we[..., (k + 1) % 3] = t
            use = outside[k] & ~taken
            w = torch.where(use[..., None], we, w)
            taken = taken | outside[k]
        q = (w[..., :, None] * p).sum(-2)
        return (x - q).norm(dim=-1), w

    def contact_set(self, x, prev, flag, pdir):
        """The contact set the step's energy uses, and the new latch.

        For every query slot: among the pair's faces whose centroid lies
        within 2 grid_h of the vertex in the max-norm (the top_k nearest by
        that distance, ties to the lower face), the closest by `closest`;
        within 1e-5 m of the closest, the one the vertex lies farthest in
        front of (the first of those within TIE_M of the farthest). The
        latch side is set where a slot finds a face for the first time, by
        the side of the face's interpolated vertex normal. Active: latched
        and the signed gap below eps. The friction scale
        k = -mu k_contact (gap - eps), the rest offset and the tangent frame
        are taken at `x` and `prev`."""
        fc = self.faces
        C = self.capacity
        cent = x[fc].mean(1)
        found = torch.zeros(C, dtype=torch.bool, device=x.device)
        tri = fc[-1].expand(C, 3).clone()
        wgt = torch.zeros((C, 3), dtype=x.dtype, device=x.device)
        wgt[:, 0] = 1.0
        for q0, count, f0, nf, is_self in self.pairs:
            vid = self.cq_vert[q0:q0 + count]
            xq = x[vid]
            linf = (cent[None, f0:f0 + nf] - xq[:, None]).abs().amax(-1)
            k = min(self.top_k, nf)
            order = torch.sort(linf, dim=1, stable=True).indices[:, :k]
            ok = torch.gather(linf, 1, order) < self.cutoff
            cand = fc[f0 + order]                         # (q, k, 3)
            if is_self:
                ok = ok & ~(cand == vid[:, None, None]).any(-1)
            p = x[cand]
            dist, w = self.closest(xq[:, None, :], p)
            dist = torch.where(ok, dist, torch.full_like(dist, np.inf))
            dmin = dist.amin(1, keepdim=True)
            n = _cross(p[..., 1, :] - p[..., 0, :],
                       p[..., 2, :] - p[..., 0, :])
            n = n / n.norm(dim=-1, keepdim=True)
            front = _dot(xq[:, None] - (w[..., None] * p).sum(-2), n)
            score = torch.where(dist < dmin + 1e-5, front,
                                torch.full_like(front, -np.inf))
            # ties go to the first candidate; scores within TIE_M of the
            # best are ties, so that rounding does not break them
            top = score.amax(1, keepdim=True)
            ar = torch.arange(k, device=x.device).expand_as(score)
            best = torch.where(score >= top - TIE_M, ar, k).amin(1)
            rows = torch.arange(count, device=x.device)
            got = torch.isfinite(dmin[:, 0])
            if is_self:
                inside = (w[rows, best] > 0).all(-1)
                got = got & inside
            found[q0:q0 + count] = got
            tri[q0:q0 + count] = cand[rows, best]
            wgt[q0:q0 + count] = w[rows, best]
        vn = self.vertex_normals(x)
        xs = x[self.cq_vert]
        side = _dot(xs - (wgt[..., None] * x[tri]).sum(1),
                    (wgt[..., None] * vn[tri]).sum(1)) > 0
        new_dir = torch.where((flag == 0) & found, side.to(pdir.dtype), pdir)
        new_flag = found.to(flag.dtype)
        # orient: an unlatched side (dir 0) swaps the face's last two
        swap = new_dir == 0
        t1 = torch.where(swap, tri[:, 2], tri[:, 1])
        t2 = torch.where(swap, tri[:, 1], tri[:, 2])
        w1 = torch.where(swap, wgt[:, 2], wgt[:, 1])
        w2 = torch.where(swap, wgt[:, 1], wgt[:, 2])
        idx = torch.stack([tri[:, 0], t1, t2, self.cq_vert], 1)
        w = torch.stack([wgt[:, 0], w1, w2], 1)
        n = _cross(x[t1] - x[tri[:, 0]], x[t2] - x[tri[:, 0]])
        n = n / n.norm(dim=1, keepdim=True).clamp_min(1e-300)
        gap = _dot(xs - (w[..., None] * x[idx[:, :3]]).sum(1), n)
        active = (new_flag == 1) & (gap < self.eps_c)
        a = torch.nonzero(active)[:, 0]
        # the tangent frame (upstream: not orthonormalised)
        na = n[a]
        small = na[:, 0].abs() < 0.5
        t1v = torch.where(small[:, None],
                          torch.stack([na[:, 0], na[:, 2], -na[:, 1]], 1),
                          torch.stack([na[:, 1], -na[:, 0], na[:, 2]], 1))
        t2v = _cross(na, t1v)
        t1v = _cross(na, t2v)
        con = {"idx": idx[a], "w": w[a], "n": na, "mu": self.cq_mu[a],
               "T": torch.stack([t1v, t2v], 1)}
        con["k"], con["dx0"] = self.friction_consts(x, prev, con)
        return con, new_flag, new_dir

    def friction_consts(self, x, prev, con):
        """k = -mu k_contact (gap - eps) at x, with the set's normal, and
        the rest offset dx0 = prev_v - sum_k w_k prev_k."""
        idx, w = con["idx"], con["w"]
        gap = _dot(x[idx[:, 3]] - (w[..., None] * x[idx[:, :3]]).sum(1),
                   con["n"])
        k = -con["mu"] * self.k_c * (gap - self.eps_c)
        dx0 = prev[idx[:, 3]] - (w[..., None] * prev[idx[:, :3]]).sum(1)
        return k, dx0

    # ------------------------------------------------------------ energy

    def elastic(self, x, ref, con, k=None, dx0=None):
        """Every energy but inertia: membrane, bending, the tetrahedra,
        the contact barrier and smoothed Coulomb friction."""
        # membrane: sum over edges kl (1 - |e|/l0)^2 l0 + ka (1 - A/A0)^2 A0
        xf = x[self.f2v]
        e = sum(self.kl * (1 - (xf[:, l] - xf[:, (l + 1) % 3]).norm(dim=-1)
                           / self.l0[:, l]) ** 2 * self.l0[:, l]
                for l in range(3))
        area = 0.5 * _cross(xf[:, 1] - xf[:, 0], xf[:, 2] - xf[:, 0]).norm(
            dim=-1)
        E = (e + self.ka * (1 - area / self.area0) ** 2 * self.area0).sum()
        # bending: kb (theta - ref)^2 dx^2/3
        th = self.hinge_angles(x)
        E = E + (self.kb * (th - ref[self.hon]) ** 2 * self.hcoef).sum()
        # tetrahedra: F = D B, D's columns x_j - x_3
        for kind, tets, B, W, mu, lam in self.tets:
            xt = x[tets]
            F = (xt[:, :3] - xt[:, 3:]).transpose(1, 2) @ B
            J = _dot(F[..., 0], _cross(F[..., 1], F[..., 2]))
            I1 = (F * F).sum((-2, -1))
            if kind == "neo":
                lj = torch.log(J.clamp_min(0.01))
                phi = 0.5 * mu * (I1 - 3) - mu * lj + 0.5 * lam * lj ** 2
            else:
                phi = 0.5 * mu * (I1 - 3) + 0.5 * lam * (J - 1 - mu / lam) ** 2
            E = E + (W * phi).sum()
        # contact: barrier on the signed gap, friction on the slip
        idx, w = con["idx"], con["w"]
        if idx.shape[0]:
            k = con["k"] if k is None else k
            dx0 = con["dx0"] if dx0 is None else dx0
            p = x[idx]
            ab = _cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            g = _dot(ab, p[:, 3] - p[:, 0]) / ab.norm(dim=-1)
            E = E + torch.where(g < self.eps_c,
                                0.5 * self.k_c * (g - self.eps_c) ** 2,
                                torch.zeros_like(g)).sum()
            slip = p[:, 3] - (w[..., None] * p[:, :3]).sum(1) - dx0
            u = torch.einsum("cti,ci->ct", con["T"], slip)
            r = torch.sqrt((u * u).sum(-1) + R2_FLOOR)
            eh = self.eh
            f0 = torch.where(r > eh, r, -r ** 3 / (3 * eh * eh) + r * r / eh
                             + eh / 3)
            E = E + (k * f0).sum()
        return E

    def inertia(self, x, prev, vel):
        X = x - prev - vel * self.dt
        return (0.5 * (self.mass * (X * X).sum(-1)).sum() / self.dt ** 2
                - (self.force * x).sum())

    def hessian(self, fn, v):
        """Autograd's Hessian of a scalar function of a flat vector."""
        return torch.func.jacrev(torch.func.grad(fn), chunk_size=512)(v)

    # ------------------------------------------------------------ step

    def newton(self, start, prev, vel, ref, con):
        """The minimiser of the incremental potential over the free DOFs,
        from `start`: Newton on the true Hessian (shifted until Cholesky
        succeeds), a halving line search on the energy, until the step is
        below NEWTON_STEP_M. Returns (positions, iterations); -1
        iterations where it did not get there."""
        free = self.free
        fidx = torch.nonzero(free)[:, 0]
        base = start.reshape(-1).detach().clone()

        def energy(v):
            x = base.index_put((fidx,), v).reshape(-1, 3)
            return self.inertia(x, prev, vel) + self.elastic(x, ref, con)

        v = base[fidx].clone()
        e0 = energy(v)
        for it in range(1, NEWTON_MAX + 1):
            g = torch.func.grad(energy)(v)
            H = self.hessian(energy, v)
            p = _spd_solve(H, g)
            alpha = 1.0
            while True:
                vn = v - alpha * p
                e1 = energy(vn)
                if e1 <= e0 + 1e-13 * e0.abs() or alpha < 1e-12:
                    break
                alpha *= 0.5
            v, e0 = vn, e1
            if float((alpha * p).abs().max()) < NEWTON_STEP_M:
                return base.index_put((fidx,), v).reshape(-1, 3), it
        return base.index_put((fidx,), v).reshape(-1, 3), -1

    def step(self, st, action):
        """One time step from state dict `st`; returns (state, record)."""
        dpos, drot = action
        g_pos = st["g_pos"] + dpos
        q = st["g_rot"]
        v = q[:, 1:]
        q = q + torch.cat([-_dot(drot, v)[:, None],
                           q[:, :1] * drot + _cross(drot, v)], 1)
        g_rot = q / q.norm(dim=1, keepdim=True)
        pos = st["pos"].clone()
        if self.g_mode != "none":
            R = self.rotation(g_rot)
            for pad, part in enumerate(self.pad_part):
                loc = st["pad_local"][pad, self.bound_local]
                pos[self.bound_global[pad]] = loc @ R[part].T + g_pos[part]
        prev = pos
        con, flag, pdir = self.contact_set(pos, prev, st["flag"], st["dir"])
        x_hat = pos + st["vel"] * self.dt + self.force / self.mass[:, None] \
            * self.dt ** 2
        start = torch.where(self.frozen, pos, x_hat)
        new, iters = self.newton(start, prev, st["vel"], st["ref"], con)
        vel = (new - prev) * (self.damping / self.dt)
        th = self.hinge_angles(new)
        ref = st["ref"].clone()
        dis = th - ref[self.hon]
        yielded = torch.zeros(self.NH, dtype=torch.bool, device=new.device)
        yielded[self.hon] = dis.abs() > self.k_angle[self.hon]
        if self.plastic:
            ref[self.hon] = ref[self.hon] + torch.where(
                yielded[self.hon],
                (dis.abs() - self.k_angle[self.hon]) * torch.sign(dis),
                torch.zeros_like(dis))
        out = {"pos": new, "vel": vel, "ref": ref, "flag": flag, "dir": pdir,
               "g_pos": g_pos, "g_rot": g_rot, "pad_local": st["pad_local"]}
        return out, {"yield": yielded, "newton": iters}

    def rollout(self, deltas):
        """deltas: (T-1, n_part, 6) waypoint differences. Returns the tape
        as the program's buffers name it, and the Newton counts."""
        st = self.initial()
        keep = {"pos": [st["pos"]], "ref_angle": [st["ref"]],
                "gripper_rot": [st["g_rot"]], "pad_local": [st["pad_local"]],
                "yield_gate": [torch.zeros(self.NH, dtype=torch.bool,
                                           device=self.device)]}
        iters = []
        for a in deltas:
            st, rec = self.step(st, (a[:, :3], a[:, 3:]))
            for key, val in (("pos", st["pos"]), ("ref_angle", st["ref"]),
                             ("gripper_rot", st["g_rot"]),
                             ("pad_local", st["pad_local"]),
                             ("yield_gate", rec["yield"])):
                keep[key].append(val)
            iters.append(rec["newton"])
        buf = {k: torch.stack(v) for k, v in keep.items()}
        buf["final_proj_flag"], buf["final_proj_dir"] = st["flag"], st["dir"]
        return buf, iters

    # ------------------------------------------------------------ adjoint

    def backward(self, buf, seed_pos, seed_ar):
        """The upstream analytic gradient of the gripper's 6-DoF per step,
        (T, n_part, 6), by the semantics in the module's docstring."""
        with torch.enable_grad():
            return self._sweep(buf, seed_pos, seed_ar)

    def _sweep(self, buf, seed_pos, seed_ar):
        T = buf["pos"].shape[0]
        dev = self.device
        grads = torch.zeros((T, max(self.n_part, 1), 6), dtype=torch.float64,
                            device=dev)
        g1 = torch.zeros((self.NV, 3), dtype=torch.float64, device=dev)
        g2 = torch.zeros_like(g1)
        ar1 = torch.zeros(self.NH, dtype=torch.float64, device=dev)
        flag, pdir = buf["final_proj_flag"], buf["final_proj_dir"]
        hm = self.hmask.to(torch.float64)
        inert = (self.mass / self.dt ** 2)[:, None]
        unf_flat = self.unf.reshape(-1)
        for t in range(T - 1, 0, -1):
            x_t, x_m = buf["pos"][t], buf["pos"][t - 1]
            ref_t = buf["ref_angle"][t - 1]
            pg = (seed_pos[t] + g1).clamp(-1000.0, 1000.0)
            ar = (seed_ar[t] + ar1).clamp(-1000.0, 1000.0)
            con, flag, pdir = self.contact_set(x_m, x_m, flag, pdir)
            # plasticity: the rest-angle gradient into the positions
            fac = torch.where(buf["yield_gate"][t], 1.0, 0.1) * hm
            xv = x_t.detach().clone().requires_grad_(True)
            th = self.hinge_angles(xv)
            (dth_w,) = torch.autograd.grad(th, xv, (ar * fac)[self.hon])
            pg = pg + dth_w
            ar_next = ar * hm
            # the true Hessian, solved with the frozen rows as inertia only
            flat = x_t.reshape(-1)

            def elastic(v, ref=ref_t, con=con):
                return self.elastic(v.reshape(-1, 3), ref, con)

            H = self.hessian(elastic, flat)
            Hs = H * unf_flat[:, None] * unf_flat[None, :]
            Hs = Hs + torch.diag(inert.expand(-1, 3).reshape(-1))
            z = torch.linalg.solve(Hs, pg.reshape(-1)).reshape(-1, 3)
            # the pads' frozen vertices: -sum over free i of H_ij z_i
            tmp = -(H @ (z.reshape(-1) * unf_flat)).reshape(-1, 3)
            x_hat_grad = z * inert * self.unf
            # friction pressure and rest offset: -d(z . grad E)/d prev
            xm = x_m.detach().clone().requires_grad_(True)
            rv = ref_t.detach().clone().requires_grad_(True)
            xg = x_t.detach().clone().requires_grad_(True)
            k, dx0 = self.friction_consts(xm, xm, con)
            e = self.elastic(xg, rv, con, k=k, dx0=dx0)
            (gx,) = torch.autograd.grad(e, xg, create_graph=True)
            zg = (z.detach() * gx).sum()
            d_prev, d_ref = torch.autograd.grad(zg, (xm, rv),
                                                allow_unused=True)
            bp = -d_prev if d_prev is not None else torch.zeros_like(g1)
            if d_ref is not None:
                ar_next = ar_next - d_ref * hm
            grads[t] = self.gripper_grad(buf["gripper_rot"][t],
                                         buf["pad_local"][t], tmp)
            g1 = g2 + 2.0 * x_hat_grad + bp
            g2 = -x_hat_grad
            ar1 = ar_next
        return grads

    def gripper_grad(self, rot, pad_local, tmp):
        """Per part: the pads' frozen-vertex gradients summed, and their
        moments about the part's origin, over the bound vertices' count;
        clamped to +-10 and +-100."""
        d_pos = torch.zeros((self.n_part, 3), dtype=tmp.dtype,
                            device=tmp.device)
        d_ang = torch.zeros_like(d_pos)
        R = self.rotation(rot)
        for pad, part in enumerate(self.pad_part):
            gr = tmp[self.bound_global[pad]]
            arm = pad_local[pad, self.bound_local] @ R[part].T
            d_pos[part] += gr.sum(0)
            d_ang[part] += _cross(arm, gr).sum(0)
        return torch.cat([(d_pos / self.n_bound).clamp(-10.0, 10.0),
                          (d_ang / self.n_bound).clamp(-100.0, 100.0)], 1)


def _spd_solve(H, g):
    """H^-1 g, with H shifted by a growing multiple of its mean diagonal
    until its Cholesky factor exists."""
    L, info = torch.linalg.cholesky_ex(H)
    shift = 0.0
    scale = float(H.diagonal().abs().mean())
    while int(info) != 0:
        shift = scale * 1e-8 if shift == 0.0 else shift * 10.0
        L, info = torch.linalg.cholesky_ex(
            H + shift * torch.eye(H.shape[0], dtype=H.dtype, device=H.device))
    return torch.cholesky_solve(g[:, None], L)[:, 0]


class TrajOpt:
    """The trajectory optimiser's iteration: rollout, reward, adjoint seed,
    backward sweep, Adam on the waypoint table, the motion limit."""

    def __init__(self, task, T, lr, max_dist, device):
        self.m = Model(task, device)
        self.task, self.T = task, T
        self.lr, self.max_dist = lr, max_dist
        self.max_move = float(task.max_moving_dist)
        self.traj = np.zeros((T, task.n_part, 6))
        self.adam_m = np.zeros_like(self.traj)
        self.adam_v = np.zeros_like(self.traj)
        self.it = 0

    def iteration(self):
        dev = self.m.device
        deltas = torch.as_tensor(self.traj[1:] - self.traj[:-1], device=dev)
        buf, iters = self.m.rollout(deltas)
        reward = float(self.task.reward(buf))
        seed_pos, seed_ar = self.task.seed_for("default")(buf)
        grad = self.m.backward(buf, seed_pos, seed_ar)
        self.adam(grad.cpu().numpy())
        self.limit()
        return {"buffers": buf, "gripper_grad": grad, "reward": reward,
                "newton": iters}

    def adam(self, g, b1=0.9, b2=0.9999, eps=1e-8):
        """Bias-corrected Adam over sqrt(v_hat + eps); the learning rate is
        cut by 0.9 every 10 steps."""
        self.adam_m = b1 * self.adam_m + (1 - b1) * g
        self.adam_v = b2 * self.adam_v + (1 - b2) * g * g
        lr = self.lr * 0.9 ** (self.it // 10)
        self.it += 1
        m_hat = self.adam_m / (1 - b1 ** self.it)
        v_hat = self.adam_v / (1 - b2 ** self.it)
        self.traj = self.traj - lr * m_hat / np.sqrt(v_hat + eps)

    def limit(self):
        """Step by step, each part's move (|dpos| + max_dist |drot|) scaled
        down to the scene's max_moving_dist."""
        t = self.traj
        for i in range(1, self.T):
            for j in range(t.shape[1]):
                d = t[i, j] - t[i - 1, j]
                dist = np.linalg.norm(d[:3]) + np.linalg.norm(d[3:]) * \
                    self.max_dist
                wgt = self.max_move / (dist + 1e-8)
                if wgt < 1.0:
                    t[i, j] = t[i - 1, j] + d * wgt
