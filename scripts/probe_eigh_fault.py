"""Why cuSOLVER's batched eigh failed on float32 element Hessians of the
task scenes, and what the port's float64 decomposition of them costs, on
the card.

    PYTHONPATH=. python3 scripts/probe_eigh_fault.py alone DIR
    PYTHONPATH=. python3 scripts/probe_eigh_fault.py replay DIR

`alone` runs chip_smoke.py's [scenes-trajopt] iteration of lifting and
sliding (float32, T=3) in a new process, which launches no DIA kernel
(both scenes take the dense solve). It watches every batch that
`ops/spd.project_psd` decomposes: a float32 batch is decomposed again by
cuSOLVER in float32 (the port's solve before it widened them), which is
counted as refused (it raised) or non-finite (it returned NaN or inf for
a finite batch), and both solves are timed with CUDA events. The first
failing batches of each kind are saved to DIR with their block maxima.

`replay` decomposes the saved batches again in a new process: the whole
batch and its failing blocks in float32, each failing block alone, the
batch scaled to a largest entry of 1, and the batch in float64. Then it
fills the allocator's cached device memory with a sentinel value and
decomposes each saved batch and a made-up one (zero, diagonal and random
symmetric 12x12 blocks) in float32 and float64, with the eigenvalue
output left to the solver or zeroed first, against the host's float64
eigenvalues: blocks whose eigenvalues are wrong, and how many of those
hold the sentinel (left unwritten), are zero blocks, or are diagonal.
"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SAVE_PER_KIND = 2


def finite(t):
    return bool(torch.isfinite(t).all())


def f32_eigh(h):
    """('ok' | 'refused' | 'nonfinite', per-block bad mask or None)."""
    try:
        w, v = torch.linalg.eigh(h)
    except torch.linalg.LinAlgError:
        return "refused", None
    bad = ~(torch.isfinite(w).all(-1) & torch.isfinite(v).flatten(-2)
            .all(-1))
    return ("nonfinite" if bool(bad.any()) else "ok"), bad


def block_max(h):
    return h.abs().flatten(-2).amax(-1)


def watch(out_dir, tag):
    """Wrap spd._eigh: count, time and save the float32 failures."""
    from thinshelllab_torch.ops import spd

    eigh = spd._eigh
    counts = {"calls": 0, "ok": 0, "refused": 0, "nonfinite": 0,
              "f32_ms": 0.0, "port_ms": 0.0}
    saved = {"refused": 0, "nonfinite": 0}

    def timed(fn, h):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        r = fn(h)
        b.record()
        torch.cuda.synchronize()
        return r, a.elapsed_time(b)

    def watched(Hs):
        if Hs.dtype != torch.float32 or not Hs.is_cuda:
            return eigh(Hs)
        (kind, bad), ms32 = timed(f32_eigh, Hs)
        out, ms = timed(eigh, Hs)
        counts["calls"] += 1
        counts[kind] += 1
        counts["f32_ms"] += ms32
        counts["port_ms"] += ms
        if kind != "ok" and finite(Hs):
            mx = block_max(Hs)
            line = (f"   {kind} float32 {tuple(Hs.shape)}: max |H| "
                    f"{float(mx.max()):.4e}, median block max "
                    f"{float(mx.median()):.4e}")
            if bad is not None:
                line += (f"; {int(bad.sum())} blocks non-finite, their max "
                         f"|H| {float(mx[bad].max()):.4e}")
            w64 = torch.linalg.eigh(Hs.double())[0]
            cond = w64.abs().amax(-1) / w64.abs().amin(-1).clamp_min(1e-300)
            line += (f"; float64 |lambda| max {float(w64.abs().max()):.4e},"
                     f" condition max {float(cond.max()):.4e}")
            print(line, flush=True)
            if saved[kind] < SAVE_PER_KIND:
                saved[kind] += 1
                path = os.path.join(out_dir, f"{tag}_{kind}_{saved[kind]}.pt")
                torch.save({"H": Hs.cpu(), "bad": None if bad is None
                            else bad.cpu()}, path)
        if not (finite(out[0]) and finite(out[1])):
            print(f"   the port's float64 solve: non-finite output for "
                  f"{tuple(Hs.shape)}", flush=True)
        return out

    spd._eigh = watched
    return counts


def scenes_trajopt(C, counts, scenes):
    for name in scenes:
        C.NEW_SCENES = (name,)
        before = dict(counts)
        C.scenes_trajopt_phase(torch.device("cuda", 0))
        d = {k: counts[k] - before[k] for k in counts}
        n = max(d["calls"], 1)
        print(f"[probe] {name}: {d['calls']} float32 batches; cuSOLVER "
              f"float32: {d['refused']} refused, {d['nonfinite']} "
              f"non-finite, {d['ok']} ok; {d['f32_ms'] / n:.3f} ms a batch "
              f"in float32, {d['port_ms'] / n:.3f} ms in the port's float64 "
              "solve (with its finiteness check)", flush=True)


def replay(out_dir):
    files = sorted(f for f in os.listdir(out_dir) if f.endswith(".pt"))
    print(f"[replay] {len(files)} saved batches, in a process that "
          "launched no kernel of the port", flush=True)
    dev = torch.device("cuda", 0)
    for f in files:
        d = torch.load(os.path.join(out_dir, f))
        H = d["H"].to(dev)
        kind, bad = f32_eigh(H)
        mx = block_max(H)
        sub = d["bad"].to(dev) if d["bad"] is not None else None
        line = f"[replay] {f}: whole batch float32 {kind}"
        if bad is not None:
            line += f" ({int(bad.sum())} blocks)"
        if sub is not None and bool(sub.any()):
            k2, b2 = f32_eigh(H[sub])
            singles = [f32_eigh(h)[0] for h in H[sub][:8]]
            line += (f"; its {int(sub.sum())} failing blocks as a batch "
                     f"{k2}; the first {len(singles)} alone {singles}")
        scaled = H / mx.clamp_min(1e-30)[:, None, None]
        line += (f"; scaled to max 1: {f32_eigh(scaled)[0]}; float64: "
                 f"{f32_eigh(H.double())[0]}; host LAPACK float32: "
                 f"{f32_eigh(H.cpu())[0]}")
        print(line, flush=True)


SENTINEL = 7777.0


def poison(dev):
    """Fill cached device memory of both allocator pools with SENTINEL."""
    keep = [torch.full((2**28,), SENTINEL, device=dev)]
    keep += [torch.full((n,), SENTINEL, device=dev)
             for n in [2**14] * 400 + [2**16] * 200 + [2**17] * 100]
    torch.cuda.synchronize()
    del keep


def made_up(dev):
    g = torch.Generator().manual_seed(0)
    A = torch.randn((256, 12, 12), generator=g)
    A = A + A.transpose(-1, -2)
    A[:64] = 0.0
    A[64:128] = torch.diag_embed(torch.randn((64, 12), generator=g))
    return A.to(dev)


def sentinel_check(name, H, dev):
    """Decompose H with poisoned memory; compare eigenvalues with the
    host's float64 ones."""
    w_ref = torch.linalg.eigh(H.double().cpu())[0]
    mx = block_max(H.cpu().double())
    zero = mx == 0
    offd = H.cpu() - torch.diag_embed(torch.diagonal(H.cpu(), dim1=-2,
                                                     dim2=-1))
    diag = (block_max(offd) == 0) & ~zero
    for dtype in (torch.float32, torch.float64):
        for prezero in (False, True):
            poison(dev)
            Hd = H.to(dtype)
            try:
                if prezero:
                    w = torch.zeros(H.shape[:-1], dtype=dtype, device=dev)
                    v = torch.empty_like(Hd)
                    torch.linalg.eigh(Hd, out=(w, v))
                else:
                    w, v = torch.linalg.eigh(Hd)
            except torch.linalg.LinAlgError:
                print(f"[sentinel] {name} {dtype} prezero={prezero}: "
                      "refused", flush=True)
                continue
            w = w.double().cpu()
            tol = 1e-4 * mx.clamp_min(1e-30)
            bad = ~((w - w_ref).abs().amax(-1) <= tol)
            sent = (w == SENTINEL).any(-1)
            vbad = ~torch.isfinite(v.cpu()).flatten(-2).all(-1)
            print(f"[sentinel] {name} {dtype} prezero={prezero}: "
                  f"{int(bad.sum())} of {H.shape[0]} blocks with wrong "
                  f"eigenvalues ({int((bad & sent).sum())} hold the "
                  f"sentinel, {int((bad & zero).sum())} zero blocks of "
                  f"{int(zero.sum())}, {int((bad & diag).sum())} diagonal "
                  f"of {int(diag.sum())}); non-finite eigenvectors in "
                  f"{int(vbad.sum())}", flush=True)


def main():
    mode, out_dir = sys.argv[1], sys.argv[2]
    os.makedirs(out_dir, exist_ok=True)
    if mode == "replay":
        replay(out_dir)
        dev = torch.device("cuda", 0)
        sentinel_check("made-up (256, 12, 12)", made_up(dev), dev)
        for f in sorted(f for f in os.listdir(out_dir) if f.endswith(".pt")):
            H = torch.load(os.path.join(out_dir, f))["H"].to(dev)
            sentinel_check(f, H, dev)
        return
    import chip_smoke as C

    counts = watch(out_dir, mode)
    scenes_trajopt(C, counts, ("lifting", "sliding"))


if __name__ == "__main__":
    main()
