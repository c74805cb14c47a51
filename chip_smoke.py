#!/usr/bin/env python3
"""Drive the PyTorch port's FCMA voxel-selection path on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with an NVIDIA
Hopper card and the CUDA toolkit.  It imports only ``brainiak_tpu_torch``
(no jax, no ``brainiak_tpu``) and runs these phases, failing on the
first one that goes wrong:

1. Device and build: the card's name and power limit, and the nvcc
   build of every kernel under ``brainiak_tpu_torch/csrc`` (one nvcc
   per source, started together), with each kernel's registers and
   spills as ptxas reports them.
2. Each kernel against its plain PyTorch version at the shapes the
   main path gives it (inputs from a numpy seed, TF32 off, two-mask
   inputs so that no |r| is near 1):
     K2 epoch_zscore [32, 150, 65536];
     K1 fcma_gram E=32, T=150, B=1024, V=65536 (whole brain);
     K1 fcma_gram E=16, T=150, B=V=8192 (one mask: the 16-epoch
        tiling, and the 32-epoch tiling forced, both checked and timed);
     K3 fcma_corr_normalize E=32, T=150, B=128, V=65536.
   Kernel times are CUDA-event means over repeated launches after a
   warm-up; ``bound_ms`` is the larger of bytes / 3.35 TB/s and fp32
   operations / 67 TFLOP/s for this run's shapes (K1's Gram counted
   as its E (E + 1) / 2 distinct entries, the Gram being symmetric).
3. Main path, whole brain: 8 subjects x 600 TRs on a 64x64x16 volume
   (65,536 voxels), 2 conditions x 2 epochs of 150 TRs each (E=32,
   4 epochs per subject), mask1 = 1024 voxels, mask2 = the whole volume;
   ``prepare_fcma_data`` then ``VoxelSelector(..., num_folds=4)
   .run('svm')``.  The K1 and K2 launch counts of that run must be > 0.
   A warm run is timed, and one more runs under ``torch.profiler`` for
   the device time by kernel and the device's busy share.
4. Main path, one mask: V=8192, E=16, T=150, 4 epochs per subject,
   4 folds, through ``run('svm')``; kernel-vs-plain voxel accuracies
   on 256 voxels.
5. The host-CV branch, ``run(clf)`` with a precomputed-kernel
   classifier, which goes through K3 per block of voxels.

It prints progress lines, then one JSON line with every kernel's
figures, then ``{"ok": true, "device": {...}}`` as the last line.
With no CUDA device it exits 1 and prints no result.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np

PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
SEED = 0

# tolerances of the kernel-vs-plain comparisons
K2_ATOL = 1e-5      # f32, different summation order
K1_RTOL = 1e-4      # of each voxel's K[0, 0]: f32 accumulation order
# K3: |kernel - plain| * sigma <= K3_ZTOL, sigma the std of the
# subject group's Fisher-z values: the within-subject z-score divides
# by sigma, so f32 rounding of r (sum over T) shows up amplified by
# 1/sigma; scaled back, the difference is in Fisher-z units.
K3_ZTOL = 1e-5
ACC_AGREE = 0.95    # share of voxels whose accuracies are equal


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = n_flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def cuda_ms(torch, fn, reps, warmup=1):
    """Mean milliseconds of fn() over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def ptxas_summary(output):
    """``kernel<template args>: registers, spills`` for every kernel in
    nvcc's ``-Xptxas -v`` output."""
    rows, name, spill = [], None, ""
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)(I(?:Li\d+E)+E|I[fd]E)?",
                          m.group(1))
            args = re.findall(r"Li(\d+)E|I([fd])E", k.group(2) or "")
            name = k.group(1) + (
                "<" + ",".join(a or {"f": "float", "d": "double"}[b]
                               for a, b in args) + ">" if args else "")
        elif "spill stores" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows.append(f"{name}: {regs} registers; {spill}")
            name, spill = None, ""
    return rows


def normalized_epochs(torch, rng, n_e, n_t, n_v, dev):
    """[E, T, V] float32 epoch data, z-scored over T and scaled by
    1/sqrt(T), made from a numpy seed."""
    x = torch.from_numpy(rng.standard_normal((n_e, n_t, n_v),
                                             dtype=np.float32)).to(dev)
    x -= x.mean(dim=1, keepdim=True)
    x /= x.std(dim=1, keepdim=True, correction=0) * n_t ** 0.5
    return x.contiguous()


def gram_flops(n_e, n_t, n_b, n_v):
    """Operations K1 needs: the correlation (2 E T per block voxel and
    voxel) and the symmetric Gram's E (E + 1) / 2 distinct entries."""
    return 2 * n_e * n_t * n_b * n_v + n_e * (n_e + 1) * n_b * n_v


def check_k1(torch, blk, data, eps, reps, alt_ept=None):
    """K1 against its plain version (blocks of 128 voxels) on blk
    [E, T, B] and data [E, T, V]; the row of its figures.  With
    ``alt_ept`` the other epoch tiling is checked and timed too."""
    from brainiak_tpu_torch.ops import fcma_kernels as fk

    n_e, n_t, n_b = blk.shape
    n_v = data.shape[2]
    chunk = 128

    def plain():
        return torch.cat([fk.fcma_gram_plain(blk[:, :, s:s + chunk], data,
                                             eps)
                          for s in range(0, n_b, chunk)])

    def library():
        for s in range(0, n_b, chunk):
            corr = torch.einsum('etb,etv->bev', blk[:, :, s:s + chunk],
                                data)
            torch.einsum('bev,bfv->bef', corr, corr)

    want = plain()
    routes = [(None, lambda: fk.fcma_gram(blk, data, eps))]
    if alt_ept is not None:
        routes.append((alt_ept, lambda: fk._kernel_gram(blk, data, eps,
                                                        ept=alt_ept)))
    row = None
    for ept, fn in routes:
        got = fn()
        rel = ((got - want).abs() / want[:, :1, :1].abs()).max().item()
        err = (got - want).abs().max().item()
        name = "fcma_gram" + ("" if ept is None else f"[ept={ept}]")
        log(f"K1 {name} E={n_e} T={n_t} B={n_b} V={n_v} max_abs_err "
            f"{err:.3e} max err/K[0,0] {rel:.3e} (rtol {K1_RTOL})")
        if not rel <= K1_RTOL:
            fail(f"K1 ({name}) disagrees with its plain version")
        ms = cuda_ms(torch, fn, reps)
        if row is None:
            row = {"max_abs_err": err, "ms": ms}
        else:
            log(f"  K1 at E={n_e}: ept={fk.epoch_tiles(n_e, eps)[0]} "
                f"(the path's) {row['ms']:.3f} ms, ept={ept} {ms:.3f} ms")
    b_ms, b_by = bound_ms(4 * (n_e * n_t * (n_b + n_v) + n_b * n_e * n_e),
                          gram_flops(n_e, n_t, n_b, n_v))
    row.update(plain_ms=cuda_ms(torch, plain, 1), bound_ms=b_ms,
               bound_by=b_by, library_ms=cuda_ms(torch, library, 1))
    return row


def phase_kernels(torch, dev):
    from brainiak_tpu_torch.ops import fcma_kernels as fk
    from brainiak_tpu_torch.ops.correlation import correlate_epochs
    from brainiak_tpu_torch.ops.fisherz import fisher_z
    from brainiak_tpu_torch.ops.kernels import epoch_norm as en

    rng = np.random.default_rng(SEED)
    rows = {}

    # K2 at the whole-brain ingest shape
    n, t, v = 32, 150, 65536
    x = torch.from_numpy(
        rng.standard_normal((n, t, v), dtype=np.float32) * 3 + 1).to(dev)
    x[0, :, 5] = 2.5
    x[1, 3, 7] = float("nan")
    got, want = en.batch_zscore(x), en.batch_zscore_plain(x)
    err = (got - want).abs().max().item()
    log(f"K2 epoch_zscore [{n},{t},{v}] max_abs_err {err:.3e} "
        f"(atol {K2_ATOL})")
    if not err <= K2_ATOL:
        fail("K2 disagrees with its plain version")
    b_ms, b_by = bound_ms(2 * x.numel() * 4, 8 * x.numel())
    rows["epoch_zscore"] = {
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: en.batch_zscore(x), 20),
        "plain_ms": cuda_ms(torch, lambda: en.batch_zscore_plain(x), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    del x, got, want

    # K1 at the whole-brain main-path shape (two-mask inputs)
    n_e, n_t, n_b, n_v, eps = 32, 150, 1024, 65536, 4
    data = normalized_epochs(torch, rng, n_e, n_t, n_v, dev)
    blk = normalized_epochs(torch, rng, n_e, n_t, n_b, dev)
    rows["fcma_gram"] = check_k1(torch, blk, data, eps, 3)

    # K1 at the one-mask path's shape (E=16: the 16-epoch tiling),
    # with the 32-epoch tiling forced on the same inputs for comparison
    blk16 = normalized_epochs(torch, rng, 16, n_t, 8192, dev)
    data16 = normalized_epochs(torch, rng, 16, n_t, 8192, dev)
    rows["fcma_gram_e16"] = check_k1(torch, blk16, data16, eps, 5,
                                     alt_ept=32)
    del blk16, data16
    chunk = 128

    # K3 at the host-CV branch's block shape
    blk = blk[:, :, :chunk].contiguous()
    got = fk.fcma_corr_normalize(blk, data, eps)
    want = fk.fcma_corr_normalize_plain(blk, data, eps)
    z = fisher_z(correlate_epochs(blk.transpose(1, 2),
                                  data.transpose(1, 2)))
    zr = z.reshape(chunk, n_e // eps, eps, n_v)
    var = (zr * zr).mean(dim=2, keepdim=True) - \
        zr.mean(dim=2, keepdim=True) ** 2
    sigma = var.clamp(min=0).sqrt().expand_as(zr).reshape(z.shape)
    diff = (got - want).abs()
    err = diff.max().item()
    zerr = (diff * sigma).max().item()
    log(f"K3 fcma_corr_normalize E={n_e} T={n_t} B={chunk} V={n_v} "
        f"max_abs_err {err:.3e} max err*sigma {zerr:.3e} "
        f"(tol {K3_ZTOL}); share of |err| > 1e-4: "
        f"{(diff > 1e-4).float().mean().item():.2e}")
    if not zerr <= K3_ZTOL:
        fail("K3 disagrees with its plain version")
    del z, zr, var, sigma, diff, got, want
    b_ms, b_by = bound_ms(
        4 * (n_e * n_t * (chunk + n_v) + chunk * n_e * n_v),
        2 * n_e * n_t * chunk * n_v)
    rows["fcma_corr_normalize"] = {
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: fk.fcma_corr_normalize(blk, data,
                                                            eps), 5),
        "plain_ms": cuda_ms(torch, lambda: fk.fcma_corr_normalize_plain(
            blk, data, eps), 2),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, lambda: torch.einsum(
            'etb,etv->bev', blk, data), 5)}
    for name, row in rows.items():
        log(f"  {name}: ms {row['ms']:.3f} plain_ms {row['plain_ms']:.3f} "
            f"bound_ms {row['bound_ms']:.3f} ({row['bound_by']}) "
            f"library_ms {row['library_ms']}")
    return rows


def synthetic_images(rng, n_subj, shape, n_trs, planted_b, planted_v):
    """Images [x, y, z, T] with a condition-1 coupling between the
    flat voxels ``planted_b`` and ``planted_v``, and condition specs:
    epochs of 150 TRs alternate condition 0 and 1."""
    n_vox = int(np.prod(shape))
    n_ep = n_trs // 150
    images, conditions = [], []
    for _ in range(n_subj):
        data = rng.standard_normal((n_vox, n_trs), dtype=np.float32)
        shared = rng.standard_normal(n_trs, dtype=np.float32)
        cond = np.zeros((2, n_ep // 2, n_trs), dtype=np.int64)
        for k in range(n_ep):
            sl = slice(150 * k, 150 * (k + 1))
            cond[k % 2, k // 2, sl] = 1
            if k % 2:
                data[planted_b, sl] += shared[sl]
                data[planted_v, sl] += shared[sl]
        images.append(data.reshape(shape + (n_trs,)))
        conditions.append(cond)
    return images, conditions


def check_accuracies(results, n_voxels):
    accs = np.array([a for _, a in sorted(results)])
    if len(results) != n_voxels or not np.all(np.isfinite(accs)) or \
            accs.min() < 0 or accs.max() > 1:
        fail("voxel accuracies are not n_voxels finite values in [0, 1]")
    return accs


def compare_with_plain(torch, vs, accs, n_check):
    """Kernel-path accuracies of the first n_check voxels against the
    plain path (plain Gram, same shrink and batched SVM CV)."""
    from brainiak_tpu_torch.fcma.voxelselector import _shrink
    from brainiak_tpu_torch.ops.fcma_kernels import fcma_gram_plain
    from brainiak_tpu_torch.ops.svm import svm_cv_accuracy

    data1, data2 = vs._stack()
    grams = torch.cat([
        _shrink(fcma_gram_plain(vs._slice_block(data1, s, s + 32), data2,
                                vs.epochs_per_subj))
        for s in range(0, n_check, 32)])
    plain = svm_cv_accuracy(grams, vs.labels, vs.num_folds, C=vs.svm_C,
                            n_iters=vs.svm_iters, device=vs.device)
    same = float(np.mean(np.isclose(plain, accs[:n_check], rtol=0,
                                    atol=1e-6)))
    worst = float(np.max(np.abs(plain - accs[:n_check])))
    one_sample = vs.num_folds / len(vs.labels)
    log(f"  kernel vs plain accuracies on {n_check} voxels: equal on "
        f"{same:.4f}, max diff {worst:.4f} (one test sample per fold "
        f"= {one_sample:.4f})")
    if same < ACC_AGREE or worst > one_sample + 1e-6:
        fail("kernel-path accuracies disagree with the plain path")


def profile_run(torch, vs, label, t_warm, top=6):
    """Two more warm ``run('svm')`` under ``torch.profiler``, the first
    a profiler warm-up step: device time by kernel in the second, its
    number of kernel launches, and the device's busy share of its
    host-clock window and of the unprofiled warm run (``t_warm`` s)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    traced = []   # the active step's events, kept when its trace is ready
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.extend(
                     p.key_averages())) as prof:
        vs.run('svm')
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        vs.run('svm')
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
        prof.step()
    kernels = []
    for ev in traced:
        # the step annotation also shows as a device-side range
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                ev.key.startswith("ProfilerStep"):
            continue
        kernels.append((ev.self_device_time_total, ev.count, ev.key))
    busy = sum(us for us, _, _ in kernels)
    if busy <= 0:
        log(f"  {label} profile: the profiler saw no device time; "
            "breakdown not measured")
        return
    kernels.sort(reverse=True)
    log(f"  {label} profile: window {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({busy / wall_us:.3f} of the window, "
        f"{busy / (1e6 * t_warm):.3f} of the unprofiled warm run), "
        f"{sum(n for _, n, _ in kernels)} kernel launches")
    for us, n, name in kernels[:top]:
        log(f"    {us / 1e3:9.3f} ms {n:7d}x {name[:70]}")
    k1 = [(us, n) for us, n, name in kernels if "fcma_gram_kernel" in name]
    log("    K1 in the trace: " + (
        f"{k1[0][0] / 1e3:.3f} ms, {k1[0][1]}x" if k1 else "not seen"))


def run_path(torch, label, images, conditions, mask1, mask2, n_folds,
             n_check):
    from brainiak_tpu_torch.fcma import prepare_fcma_data
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector
    from brainiak_tpu_torch.ops import fcma_kernels as fk
    from brainiak_tpu_torch.ops.kernels import epoch_norm as en

    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    en.reset_launches()
    t0 = time.perf_counter()
    raw1, raw2, labels = prepare_fcma_data(images, conditions, mask1,
                                           mask2)
    t_prep = time.perf_counter() - t0
    vs = VoxelSelector(labels, 4, n_folds, raw1, raw_data2=raw2)
    results = vs.run('svm')
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = dict(fk.launches(), epoch_zscore=en.launches())
    n_sel = vs.num_voxels
    if launches["fcma_gram"] < 1 or launches["epoch_zscore"] < 1:
        fail(f"{label}: the main path did not run K1 and K2: {launches}")
    accs = check_accuracies(results, n_sel)
    t0 = time.perf_counter()
    vs.run('svm')
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    log(f"{label}: E={len(labels)} V1={n_sel} V2={vs.num_voxels2} "
        f"prepare {t_prep:.2f} s, cold path {t_cold:.2f} s, warm "
        f"run('svm') {t_warm:.3f} s = {n_sel / t_warm:.1f} voxels/s; "
        f"max KKT gap {float(np.max(vs.kkt_gaps_)):.3e}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {launches}")
    profile_run(torch, vs, label, t_warm)
    compare_with_plain(torch, vs, accs, n_check)
    return vs, accs, launches


class _KernelNearestMean:
    """A precomputed-kernel classifier with the scikit-learn
    fit/score interface: the class whose training samples have the
    largest mean kernel value (less half the class's mean Gram)."""

    kernel = "precomputed"

    def fit(self, k_train, y):
        self.classes_ = np.unique(y)
        self.y_ = np.asarray(y)
        self.offset_ = np.array([
            0.5 * k_train[np.ix_(self.y_ == c, self.y_ == c)].mean()
            for c in self.classes_])
        return self

    def score(self, k_test, y):
        means = np.stack([k_test[:, self.y_ == c].mean(axis=1)
                          for c in self.classes_], axis=1)
        pred = self.classes_[np.argmax(means - self.offset_, axis=1)]
        return float(np.mean(pred == np.asarray(y)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's path needs one",
              file=sys.stderr)
        return 1
    from brainiak_tpu_torch import set_fp32_defaults
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector
    from brainiak_tpu_torch.ops import fcma_kernels as fk
    from brainiak_tpu_torch.ops.kernels import _build

    set_fp32_defaults()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}")
    log(nvidia_smi())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name in sorted(built):
        for row in ptxas_summary(built[name][1]):
            log(f"  {row}")

    rows = phase_kernels(torch, dev)
    torch.cuda.empty_cache()

    # main path, whole brain (two masks)
    rng = np.random.default_rng(SEED + 1)
    shape = (64, 64, 16)
    n_vox = int(np.prod(shape))
    order = rng.permutation(n_vox)
    sel, planted_v = np.sort(order[:1024]), order[1024:3072]
    images, conditions = synthetic_images(rng, 8, shape, 600, sel[:16],
                                          planted_v)
    mask1 = np.zeros(shape, dtype=bool)
    mask1.flat[sel] = True
    vs, accs, launches = run_path(torch, "whole brain", images,
                                  conditions, mask1,
                                  np.ones(shape, dtype=bool), 4, 256)
    top = set(np.argsort(-accs, kind="stable")[:16].tolist())
    log(f"  planted voxels in the top 16: {len(top & set(range(16)))}"
        f"/16; mean accuracy of the rest {accs[16:].mean():.3f}")
    if len(top & set(range(16))) < 12:
        fail("the planted voxels do not rank at the top")
    for name in ("fcma_gram", "epoch_zscore"):
        rows[name]["launches"] = launches[name]

    # host-CV branch on the same data: K3 per block of 128 voxels
    raw1 = [m[:, :256] for m in vs.raw_data]
    hvs = VoxelSelector(vs.labels, 4, 4, raw1, raw_data2=vs.raw_data2,
                        voxel_unit=128)
    hvs._stack()
    fk.reset_launches()
    t0 = time.perf_counter()
    host = hvs.run(_KernelNearestMean())
    t_host = time.perf_counter() - t0
    rows["fcma_corr_normalize"]["launches"] = \
        fk.launches()["fcma_corr_normalize"]
    check_accuracies(host, 256)
    log(f"host-CV branch: 256 voxels in {t_host:.2f} s, K3 launches "
        f"{rows['fcma_corr_normalize']['launches']}")
    if rows["fcma_corr_normalize"]["launches"] < 1:
        fail("the host-CV branch did not run K3")
    del vs, hvs, images
    torch.cuda.empty_cache()

    # main path, one mask (V=8192, E=16)
    shape = (32, 32, 8)
    n_vox = int(np.prod(shape))
    order = rng.permutation(n_vox)
    images, conditions = synthetic_images(rng, 4, shape, 600, order[:16],
                                          order[16:1040])
    _, _, launches = run_path(torch, "one mask", images, conditions,
                              np.ones(shape, dtype=bool), None, 4, 256)
    rows["fcma_gram_e16"]["launches"] = launches["fcma_gram"]

    replaces = {
        "fcma_gram": "brainiak_tpu/ops/pallas_kernels.py:223",
        "fcma_gram_e16": "brainiak_tpu/ops/pallas_kernels.py:223",
        "epoch_zscore": "brainiak_tpu/ops/kernels/epoch_norm.py:118",
        "fcma_corr_normalize": "brainiak_tpu/ops/pallas_kernels.py:168",
    }
    sources = {
        "fcma_gram": "brainiak_tpu_torch/csrc/fcma_corr.cu",
        "fcma_gram_e16": "brainiak_tpu_torch/csrc/fcma_corr.cu",
        "epoch_zscore": "brainiak_tpu_torch/csrc/epoch_norm.cu",
        "fcma_corr_normalize": "brainiak_tpu_torch/csrc/fcma_corr.cu",
    }
    kernels = [dict(name=name, route="cuda", source=sources[name],
                    replaces=replaces[name], launches=row["launches"],
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"],
                    library_ms=row["library_ms"])
               for name, row in rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
