"""Chip smoke test of the PyTorch/CUDA port (`raft_tpu_torch`) on one GPU.

    python3 chip_smoke.py              # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse   # tiny geometry on the CPU: checks the
                                       # control flow, prints no result, exits 3

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel under raft_tpu_torch/csrc/ (one nvcc per source,
     all started together);
  3. each kernel against its plain PyTorch version at small adversarial
     shapes (ties, ragged edges, +inf slots and tiles, empty chunks, k
     past the finite slots);
  4. the main path at full size: 1M x 96 clustered vectors (1024 blob
     centers U(-5, 5) plus unit gaussian noise, made from --seed), IVF-PQ
     build (n_lists 1024, pq_dim 48, kmeans_n_iters 10), exact truth with
     brute_force.knn(engine="fused") for 4096 queries at k = 10, then the
     refined ladder (n_probes 8/16/32/64, a 4k shortlist from the fused
     list-major trim, refine(strategy="fused")); gate recall@10 >= 0.95 on
     some rung. Every kernel's launch count is set to 0 just before this
     phase and read just after; each must be > 0;
  5. each kernel against its plain version on the inputs the main path gave
     it, with kernel, plain and library times (CUDA events) and the bound;
  6. a JSON line of kernels, then the device line last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate, HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
RECALL_GATE = 0.95
#: values agree to this relative tolerance, scaled by the row's largest
#: finite magnitude (the f32 sums run in another order in kernel and plain)
VAL_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# comparison and timing
# ---------------------------------------------------------------------------


def compare(name, kernel_out, plain_out, k):
    """Hold a kernel's (values, ids) against its plain version's. Values
    agree to VAL_RTOL times the row's largest finite magnitude; ids agree
    exactly except where the plain version's neighbouring scores lie
    within that tolerance (a near-tie that the two summation orders may
    break either way). Returns the max abs error over finite values."""
    kv, ki = (t[..., :k].float().cpu().reshape(-1, k) for t in kernel_out)
    pv, pi = (t[..., :k].float().cpu().reshape(-1, k) for t in plain_out)
    kfin, pfin = torch.isfinite(kv), torch.isfinite(pv)
    if not torch.equal(kfin, pfin):
        raise AssertionError(f"{name}: finite slots differ")
    scale = torch.where(pfin, pv.abs(), 0.0).amax(dim=1, keepdim=True).clamp_min(1.0)
    tol = VAL_RTOL * scale
    err = torch.where(pfin, (kv - pv).abs(), 0.0)
    if bool((err > tol).any()):
        raise AssertionError(f"{name}: values differ by up to {float(err.max())}")
    gap_prev = torch.full_like(pv, float("inf"))
    gap_prev[:, 1:] = (pv[:, 1:] - pv[:, :-1]).abs()
    gap_next = torch.zeros_like(pv)  # the last slot borders unseen candidates
    gap_next[:, :-1] = (pv[:, 1:] - pv[:, :-1]).abs()
    gap_next[:, -1] = 0.0
    tied = (gap_prev <= tol) | (gap_next <= tol)
    bad = (ki != pi) & pfin & ~tied
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} ids differ away from near-ties")
    agree = float(((ki == pi) | ~pfin).float().mean())
    return float(err.max()), agree


def time_ms(fn, reps, warmup=1):
    """Mean milliseconds per call over `reps` calls, by CUDA events (a
    CPU rehearsal, which reports no times, runs the calls only)."""
    for _ in range(warmup):
        fn()
    if not torch.cuda.is_available():
        for _ in range(reps):
            fn()
        return float("nan")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: adversarial shapes
# ---------------------------------------------------------------------------


def adversarial_checks(fs, dev, rng):
    """Kernel vs plain at small shapes built to break a kernel: integer
    grids (ties everywhere), ragged widths, +inf slots and whole +inf
    tiles, empty chunks, k past the finite slots."""

    def list_case(name, ncb, chunk, L, rot, k, n_lists, dtype, grid, ip=False, cv=False,
                  inf_frac=0.1, inf_tiles=(), rows=False):
        if grid:
            q = rng.integers(-3, 4, (ncb, chunk, rot)).astype(np.float32)
            st = rng.integers(-3, 4, (n_lists, L, rot)).astype(np.float32)
        else:
            q = rng.standard_normal((ncb, chunk, rot)).astype(np.float32)
            st = rng.standard_normal((n_lists, L, rot)).astype(np.float32) * 30
        store = torch.tensor(st)
        store = (store.clamp(-127, 127).round().to(torch.int8) if dtype == torch.int8
                 else store.to(dtype))
        base = torch.tensor(rng.integers(0, 20, (n_lists, 1, L)).astype(np.float32))
        base[torch.tensor(rng.random((n_lists, 1, L)) < inf_frac)] = float("inf")
        for t in inf_tiles:  # whole 128-slot tiles of +inf base skip their dots
            base[:, :, 128 * t:128 * (t + 1)] = float("inf")
        lof = torch.tensor(rng.integers(0, n_lists, ncb).astype(np.int32))
        cvt = torch.tensor((rng.random(ncb) < 0.7).astype(np.int32)).to(dev) if cv else None
        crt = (torch.tensor(rng.integers(0, chunk + 1, ncb).astype(np.int32)).to(dev)
               if rows else None)
        args = [t.to(dev) for t in (lof, torch.tensor(q), store, base)]
        out = fs.fused_list_topk(*args, k, inner_product=ip, chunk_valid=cvt, chunk_rows=crt)
        ref = fs.fused_list_topk_plain(*args, k, fs.fused_kbuf(k), ip, cvt, crt)
        err, agree = compare(name, out, ref, k)
        if grid and agree != 1.0:
            raise AssertionError(f"{name}: integer-grid ids must match exactly ({agree})")
        log(f"check {name}: ok, max_abs_err {err}, id agreement {agree}")

    def flat_case(name, m, n, d, k, grid, ip=False):
        gen = (lambda s: rng.integers(-3, 4, s)) if grid else rng.standard_normal
        x = torch.tensor(gen((m, d)).astype(np.float32), device=dev)
        y = torch.tensor(gen((n, d)).astype(np.float32), device=dev)
        out = fs.fused_topk(x, y, k, inner_product=ip)
        yb = y.to(torch.bfloat16)
        base = torch.zeros(n, device=dev) if ip else (yb.float() ** 2).sum(1)
        ref = fs.fused_topk_plain(x.to(torch.bfloat16).float(), yb, base, k,
                                  fs.fused_kbuf(k), ip)
        kk = min(k, n)
        err, agree = compare(name, (out[0][:, :kk], out[1][:, :kk]),
                             (ref[0][:, :kk], ref[1][:, :kk]), kk)
        if grid and agree != 1.0:
            raise AssertionError(f"{name}: integer-grid ids must match exactly ({agree})")
        if bool((out[1][:, kk:k] != fs._ID_SENTINEL).any()):
            raise AssertionError(f"{name}: exhausted slots must hold the sentinel")
        log(f"check {name}: ok, max_abs_err {err}, id agreement {agree}")

    list_case("list int8 grid, empty chunks", 40, 128, 256, 96, 40, 7, torch.int8, True, cv=True)
    list_case("list bf16 grid, chunk 1", 50, 1, 128, 96, 10, 50, torch.bfloat16, True)
    list_case("list f32 grid ragged, ip", 9, 5, 384, 33, 100, 3, torch.float32, True, ip=True)
    list_case("list k > finite slots", 6, 3, 128, 20, 200, 2, torch.float32, True, inf_frac=0.5)
    list_case("list int8 gaussian", 30, 128, 512, 96, 40, 5, torch.int8, False, cv=True)
    list_case("list live-row prefixes, ip", 40, 128, 384, 96, 40, 5, torch.int8, True, ip=True,
              cv=True, rows=True)
    list_case("list +inf tiles, k > finite slots", 7, 19, 640, 96, 256, 3, torch.int8, True,
              inf_frac=0.6, inf_tiles=(0, 2, 4))
    list_case("list long, int8 gaussian", 12, 128, 3840, 96, 40, 4, torch.int8, False,
              inf_tiles=tuple(range(8, 30)))
    for k in (1, 10, 100):
        flat_case(f"flat grid k={k}", 37, 1000, 40, k, True)
        flat_case(f"flat grid ip k={k}", 21, 777, 96, k, True, ip=True)
    flat_case("flat n < k", 5, 50, 8, 100, True)
    flat_case("flat gaussian", 100, 5000, 96, 10, False)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def make_blobs(seed, n, dim, nq, n_blobs):
    """Clustered f32 data as bench.py makes it: blob centers U(-5, 5),
    unit gaussian noise; the queries come from the same blobs."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5.0, 5.0, (n_blobs, dim)).astype(np.float32)
    data = centers[rng.integers(0, n_blobs, n)]
    data += rng.standard_normal((n, dim), dtype=np.float32)
    queries = centers[rng.integers(0, n_blobs, nq)]
    queries += rng.standard_normal((nq, dim), dtype=np.float32)
    return data, queries


def recall(ids, truth):
    ids, truth = ids.cpu().numpy(), truth.cpu().numpy()
    k = truth.shape[1]
    return float(np.mean([len(set(ids[i]) & set(truth[i])) / k for i in range(len(truth))]))


class Spy:
    """Keeps the arguments of the first calls to a kernel wrapper, so the
    kernel can be held against its plain version on the very inputs the
    main path gave it. The wrapper itself runs unchanged and keeps its
    own launch count."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.orig(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def main_path(g, dev, fs, sync):
    from raft_tpu_torch.neighbors import brute_force, ivf_pq
    from raft_tpu_torch.neighbors.refine import refine

    t0 = time.perf_counter()
    data_np, queries_np = make_blobs(g.seed, g.n, g.dim, g.nq, g.n_lists)
    dataset = torch.from_numpy(data_np).to(dev)
    queries = torch.from_numpy(queries_np).to(dev)
    sync()
    log(f"data: {g.n} x {g.dim}, {g.nq} queries, made in {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=g.n_lists, pq_dim=g.dim // 2,
                                            kmeans_n_iters=10),
                         dataset, seed=g.seed, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    log(f"build: {index} in {build_s:.3f} s, max list {int(index.list_sizes.max())}")

    with Spy(fs, "fused_topk") as flat_spy:
        t0 = time.perf_counter()
        _, truth = brute_force.knn(dataset, queries, g.k, engine="fused", device=dev)
        sync()
        truth_s = time.perf_counter() - t0
    log(f"truth: brute_force.knn(engine='fused') in {truth_s:.3f} s")

    rungs = []
    captured = {}
    for n_probes in (8, 16, 32, 64):
        params = ivf_pq.SearchParams(n_probes=n_probes)

        def run():
            _, cand = ivf_pq.search(params, index, queries, 4 * g.k)
            return refine(dataset, queries, cand, g.k, strategy="fused", device=dev)

        with Spy(fs, "fused_list_topk") as list_spy:
            _, ids = run()  # first run: recall, and the kernels' inputs
            sync()
        if n_probes == 8:
            captured["trim"], captured["refine"] = list_spy.calls[0], list_spy.calls[-1]
        r = recall(ids, truth)
        # QPS: windows of back-to-back batches, one synchronize at each
        # window's end, so every stall inside a window counts
        windows = []
        for _ in range(g.windows):
            sync()
            t0 = time.perf_counter()
            for _ in range(g.batch_reps):
                run()
            sync()
            windows.append(time.perf_counter() - t0)
        s = sum(windows) / (len(windows) * g.batch_reps)
        w_qps = [g.nq * g.batch_reps / w for w in windows]
        rungs.append({"n_probes": n_probes, "refine": True, "recall": r, "qps": g.nq / s,
                      "batch_s": s, "window_qps": w_qps})
        log(f"rung n_probes={n_probes} + refine: recall@{g.k} {r:.4f}, "
            f"{g.nq / s:.1f} qps ({s * 1e3:.4f} ms per {g.nq}-query batch over "
            f"{len(windows)} windows of {g.batch_reps} batches; window qps "
            f"{min(w_qps):.1f} .. {max(w_qps):.1f})")
    captured["flat"] = flat_spy.calls[0]
    breakdown = None
    if dev.type == "cuda":
        params8 = ivf_pq.SearchParams(n_probes=8)
        breakdown = device_breakdown(
            lambda: refine(dataset, queries, ivf_pq.search(params8, index, queries, 4 * g.k)[1],
                           g.k, strategy="fused", device=dev), g.batch_reps,
            rungs[0]["batch_s"] * 1e3)
    return {"build_s": build_s, "truth_s": truth_s, "rungs": rungs, "breakdown": breakdown,
            "dataset": dataset, "queries": queries, "truth": truth}, captured


def device_breakdown(run, reps, batch_ms):
    """Where a batch's time goes: `reps` batches under torch.profiler.
    Only the device's own activities count (kernels, copies, sets: events
    whose device_type is CUDA); the operator rows that launched them carry
    the same time again and are left out. Busy time is the union of those
    intervals. The idle share is read twice: against the profiled wall,
    and against `batch_ms`, the unprofiled batch time of the same rung
    (the profiler slows the host, not the device's work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, reach, per_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        per_name[name] = per_name.get(name, 0.0) + (end - start)
    device_ms = busy_us / 1e3 / reps
    ops = sorted(((name, us / 1e3 / reps) for name, us in per_name.items()), key=lambda kv: -kv[1])
    out = {"wall_ms": wall_ms, "device_ms": device_ms, "device_events": len(spans),
           "idle_share": 1.0 - device_ms / wall_ms,
           "idle_share_unprofiled": 1.0 - device_ms / batch_ms,
           "top": [{"kernel": name[:80], "ms": ms} for name, ms in ops[:10]]}
    log(f"breakdown, n_probes 8 + refine, per batch: device busy {device_ms:.4f} ms "
        f"({len(spans) // reps} device activities); profiled wall {wall_ms:.4f} ms, idle "
        f"share {out['idle_share']:.4f}; unprofiled batch {batch_ms:.4f} ms, idle share "
        f"{out['idle_share_unprofiled']:.4f}")
    for row in out["top"]:
        log(f"  {row['ms']:9.4f} ms  {row['kernel']}")
    if not spans or device_ms > wall_ms:
        raise AssertionError(f"profile read no device activity or too much: {device_ms} ms")
    return out


def check_truth(res, k, dev):
    """Cross-check the fused truth against numpy float64 exact kNN on 16
    queries x the first 100k rows (bench.py's check): agreement >= 0.95
    (bf16 rounding and f32 sums may flip near-ties at rank k)."""
    from raft_tpu_torch.neighbors import brute_force

    ns = min(100_000, res["dataset"].shape[0])
    sub = res["dataset"][:ns].cpu().numpy().astype(np.float64)
    qs = res["queries"][:16].cpu().numpy().astype(np.float64)
    d2 = (qs * qs).sum(1)[:, None] + (sub * sub).sum(1)[None, :] - 2.0 * qs @ sub.T
    ref = np.argsort(d2, axis=1, kind="stable")[:, :k]
    _, got = brute_force.knn(res["dataset"][:ns], res["queries"][:16], k, engine="fused",
                             device=dev)
    agree = recall(got, torch.from_numpy(ref))
    log(f"truth check vs numpy float64 (16 queries x {ns} rows): agreement {agree:.4f}")
    if agree < 0.95:
        raise AssertionError(f"truth disagrees with numpy float64: {agree}")


# ---------------------------------------------------------------------------
# phase 5: kernels on the main path's inputs
# ---------------------------------------------------------------------------


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def list_kernel_row(fs, call, launches, reps, label):
    (lof, qres, store, base, k), kw = call[0], call[1]
    ip = bool(kw.get("inner_product", False))
    cv, cr = kw.get("chunk_valid"), kw.get("chunk_rows")
    kb = kw.get("kbuf") or fs.fused_kbuf(k)
    ncb, chunk, rot = qres.shape
    L = store.shape[1]
    live = fs._live_rows(cv, cr, chunk)
    if live is None:
        live = torch.full((ncb,), chunk, dtype=torch.int32, device=lof.device)
    slots = torch.isfinite(base[:, 0, :]).sum(1)  # each list's real slots
    lists = torch.unique(lof[live > 0].long())
    # work this run's data needs: each chunk's live rows against its
    # list's real slots; bytes: operands read once (live rows, the real
    # slots and base rows of the distinct lists touched, the chunk
    # tables), outputs written once
    flops = 2.0 * float((live.long() * slots[lof.long()]).sum()) * rot
    nbytes = (ncb * 8 + int(live.sum()) * rot * 4
              + int(slots[lists].sum()) * rot * store.element_size() + lists.numel() * L * 4
              + ncb * chunk * kb * 8)
    b_ms, b_by = bound_ms(flops, nbytes)

    def kernel():
        return fs.fused_list_topk(lof, qres, store, base, k, kbuf=kb, inner_product=ip,
                                  chunk_valid=cv, chunk_rows=cr)

    def plain():
        return fs.fused_list_topk_plain(lof, qres, store, base, k, kb, ip, cv, cr)

    err, agree = compare(f"fused_list_topk ({label})", kernel(), plain(), k)
    ms = time_ms(kernel, reps)
    plain_ms = time_ms(plain, max(1, reps // 4))
    coef = 1.0 if ip else 2.0

    def library():
        st = store[lof.long()].to(torch.bfloat16)
        sc = base[lof.long()] - coef * torch.bmm(qres.to(torch.bfloat16), st.transpose(1, 2))
        return torch.topk(sc, k, dim=-1, largest=False)

    lib_ms = time_ms(library, reps)
    log(f"kernel fused_list_topk ({label}): ncb {ncb} ({int((live > 0).sum())} live, "
        f"{int(live.sum())} live rows), chunk {chunk}, L {L}, "
        f"rot {rot}, store {store.dtype}, k {k}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max_abs_err {err}, "
        f"id agreement {agree}")
    return {"name": "fused_list_topk", "route": "cuda",
            "source": "raft_tpu_torch/csrc/fused_list_topk.cu",
            "replaces": "raft_tpu/ops/fused_scan.py:443", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"{label}: ncb={ncb} chunk={chunk} L={L} rot={rot} k={k}"}


def flat_kernel_row(fs, call, launches, reps):
    (x, y, k), kw = call[0], call[1]
    ip = bool(kw.get("inner_product", False))
    m, d = x.shape
    n = y.shape[0]
    kb = fs.fused_kbuf(k)
    flops = 2.0 * m * n * d
    nbytes = (m + n) * d * 4 + m * kb * 8
    b_ms, b_by = bound_ms(flops, nbytes)
    out = fs.fused_topk(x, y, k, inner_product=ip)
    yb = y.to(torch.bfloat16)
    base = torch.zeros(n, device=y.device) if ip else (yb.float() ** 2).sum(1)
    xb = x.to(torch.bfloat16).float()

    def plain():
        return fs.fused_topk_plain(xb, yb, base, k, kb, ip)

    err, agree = compare("fused_topk (truth)", out, plain(), k)
    ms = time_ms(lambda: fs.fused_topk(x, y, k, inner_product=ip), reps, warmup=0)
    plain_ms = time_ms(plain, 1, warmup=0)
    coef = 1.0 if ip else 2.0
    xh, yh, bh = x.to(torch.bfloat16), yb, base.to(torch.bfloat16)

    def library():
        return torch.topk(torch.addmm(bh[None, :], xh, yh.T, alpha=-coef), k, dim=1,
                          largest=False)

    lib_ms = time_ms(library, reps)
    log(f"kernel fused_topk (truth): m {m}, n {n}, d {d}, k {k}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"max_abs_err {err}, id agreement {agree}")
    return {"name": "fused_topk", "route": "cuda", "source": "raft_tpu_torch/csrc/fused_topk.cu",
            "replaces": "raft_tpu/ops/fused_scan.py:267", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"truth: m={m} n={n} d={d} k={k}"}


# ---------------------------------------------------------------------------


def device_header():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return smi[0] if smi else ""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny geometry on the CPU; prints no result and exits 3")
    ap.add_argument("--seed", type=int, default=0)
    g = ap.parse_args(argv)
    if g.rehearse:
        g.n, g.dim, g.nq, g.k, g.n_lists, g.reps, g.batch_reps, g.windows = (
            20_000, 32, 256, 10, 64, 1, 1, 1)
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
                  file=sys.stderr)
            return 1
        # kernel timings over 3 calls; search QPS over 3 windows of 10
        # back-to-back batches each
        g.n, g.dim, g.nq, g.k, g.n_lists, g.reps, g.batch_reps, g.windows = (
            1_000_000, 96, 4096, 10, 1024, 3, 10, 3)
        dev = torch.device("cuda", 0)
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import fused_scan as fs

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_all = time.perf_counter()
    card = device_header() if dev.type == "cuda" else "cpu rehearsal"
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    if dev.type == "cuda":
        t0 = time.perf_counter()
        reports = _build.build_all()
        log(f"build kernels: {time.perf_counter() - t0:.3f} s")
        for src, rep in reports.items():
            for line in rep.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")
    adversarial_checks(fs, dev, np.random.default_rng(g.seed + 1))

    fs.reset_launch_counts()
    res, captured = main_path(g, dev, fs, sync)
    launches = fs.launch_counts()
    log(f"main-path launches: {launches}")
    check_truth(res, g.k, dev)
    best = max(r["recall"] for r in res["rungs"])
    if best < RECALL_GATE:
        raise AssertionError(f"no rung reached recall@{g.k} >= {RECALL_GATE} (best {best})")
    missing = [name for name, c in launches.items() if c <= 0]
    if missing and dev.type == "cuda":
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    rows = [list_kernel_row(fs, captured["trim"], launches["fused_list_topk"], g.reps,
                            "IVF-PQ trim, n_probes 8"),
            flat_kernel_row(fs, captured["flat"], launches["fused_topk"], g.reps)]
    refine_row = list_kernel_row(fs, captured["refine"], launches["fused_list_topk"], g.reps,
                                 "refine, chunk 1")
    summary = {"build_s": res["build_s"], "truth_s": res["truth_s"], "rungs": res["rungs"],
               "breakdown": res["breakdown"], "refine_kernel": refine_row, "wall_s": time.perf_counter() - t_all}
    log("summary " + json.dumps(summary))
    if dev.type != "cuda":
        log("rehearsal complete: control flow ran on the CPU; no result printed")
        return 3
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
