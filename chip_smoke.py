#!/usr/bin/env python3
"""Drive the PyTorch port's paths (FCMA voxel selection and
classification, the SUMMA ring Gram, ISC/ISFC) on one CUDA card.

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
   main paths give it (inputs from a numpy seed, TF32 off, two-region
   inputs so that no |r| is near 1):
     K2 epoch_zscore [32, 150, 65536] (whole-brain ingest) and [216,
        12, 65536] (the study's), through the paths' tile route
        (epoch_norm_tile.cu) and, on the same inputs, epoch_norm.cu's
        simple kernel forced (bit for bit the same output), timed in
        turns, beside plain and a copy of the same bytes;
     K1 fcma_gram E=32, T=150, B=1024, V=65536 (whole brain), through
        the path's tensor-core kernel (fcma_gram_tc.cu) and, on the
        same inputs, fcma_corr.cu's FMA kernel forced (route="ffma");
     K1 fcma_gram E=16, T=150, B=V=8192 (one mask: both kernels at the
        16-epoch tiling, and the tensor-core one at the 32-epoch
        tiling forced, all checked and timed);
     K3 fcma_corr_normalize E=32, T=150, B=128 and 256, V=65536,
        through the path's tensor-core kernel (fcma_corr_tc.cu) and, on
        the same inputs, fcma_corr.cu's FMA kernel forced;
     K4 fcma_sample_gram N=32, T=150, 65536 x 1024 (the classifier's
        whole-brain shape) with norm_unit 4 and 0 (raw features),
        through the path's tensor-core kernel (fcma_sample_gram_tc.cu)
        and, on the same inputs, fcma_sample_gram.cu's FMA kernel
        forced; and N=96, 8192 x 1024, norm_unit 12 (four sample tiles)
        through the multi-tile tensor-core kernel
        (fcma_sample_gram_tcm.cu: all 96 samples of a block at once),
        beside the FMA kernel forced;
     K1, K3 and K4 with subjects of 40 epochs (E=80, 512 x 4096; K3 on
        128 block voxels): each subject spans two epoch tiles.  K1
        through its multi-tile tensor-core kernel (fcma_gram_tcm.cu:
        all 80 epochs of a block at once, no statistics pass) and K3
        through its long-subject tensor-core kernel (fcma_corr_tcl.cu:
        chunks of 4 epochs, the raw z read back and z-scored), each
        beside fcma_corr.cu's FMA kernel forced on the same inputs; K4
        (N=80, groups of 40) through its multi-tile tensor-core kernel,
        beside its FMA kernel (statistics pass) forced;
     K3 with subjects of 12 epochs (E=96, T=150, B=128, V=16384)
        through fcma_corr_tcl.cu, beside the FMA kernel forced;
     K1 beyond 104 epochs through its slab route ("tcs": K3's
        tensor-core body writes a slab of normalized correlation once,
        fcma_gram_tcs.cu forms its Gram in 3xTF32), each beside
        fcma_corr.cu's FMA kernel forced (timed over one run): E=216 of
        12 a subject, T=12, B=1024, V=65536 (the study path's shape;
        fcma_corr_tcl.cu in its raw mode, z-scored as the Gram loads
        it), and E=128 of 4 a subject, T=150, B=512, V=4096 (K1's E=80
        widths; fcma_corr_tc.cu), each with its two stages' device
        times from one call (CUDA events) and the slab's floor (written
        once, read once);
     K4 beyond 104 samples through its slab route ("tcs": K1's slab
        route with samples for epochs, fcma_corr_tcl.cu's raw mode, or
        its r mode on raw features, then fcma_gram_tcs.cu, then
        fcma_sample_gram_tcs.cu adds the per-block-voxel Grams):
        N=216 in groups of 12, T=12, 1024 x 65536 (the study's stage
        2), beside fcma_sample_gram.cu's FMA kernel forced (timed over
        one run); N=128 in groups of 4, T=150, 512 x 4096, beside the
        FMA kernel; and N=128 raw there; each with its three stages'
        device times from one call (CUDA events).
   Kernel times are CUDA-event means over repeated launches after a
   warm-up; ``bound_ms`` is the larger of bytes / 3.35 TB/s and the
   operations over the peak rate of their type: fp32 FMA at 67
   TFLOP/s, and for the tensor-core K1, K3, K4 and K5 their
   correlation's or product's three TF32 products at 494.7 TFLOP/s
   (plus K1's and K4's Gram in fp32, but in 3xTF32 too for K1's slab
   route; K3's tensor-core kernels are bound by their bytes; the Grams
   counted as their
   E (E + 1) / 2 distinct entries, being symmetric, and so K5's block
   when its panel is the resident block itself).
3. Main path, whole brain: 8 subjects x 600 TRs on a 64x64x16 volume
   (65,536 voxels), 2 conditions x 2 epochs of 150 TRs each (E=32,
   4 epochs per subject), mask1 = 1024 voxels, mask2 = the whole volume;
   ``prepare_fcma_data`` then ``VoxelSelector(..., num_folds=4)
   .run('svm')``.  That run must launch K2 on its tile route alone
   and the tensor-core K1 once (every FCMA path below launches K2 on
   its tile route alone, the long subjects' epochs normalized by
   ``normalize_epochs``).
   A warm run is timed, and one more runs under ``torch.profiler`` for
   the device time by kernel and the device's busy share.  Then the
   host-CV branch, ``run(clf)`` with a precomputed-kernel classifier,
   which goes through K3 per block of voxels (``voxel_unit`` 128 and
   the default 256): every K3 launch must take the tensor-core kernel.
4. Stage 2 on the same data, trained on the first 6 subjects' 24
   epochs and tested on the last 2 subjects' 8: a portioned
   ``Classifier`` fit through K4 over mask1 x the whole volume (every
   launch on the tensor-core kernel; its test similarities and
   predictions held against the plain K4), and
   a single-portion fit on the self-correlation of the 512 voxels
   stage 1 ranked first; warm fit and predict seconds, peak device
   memory, and a held-out accuracy of at least 0.75 for both.
5. Main path, one mask: V=8192, E=16, T=150, 4 epochs per subject,
   4 folds, through ``run('svm')`` (the tensor-core K1 once);
   kernel-vs-plain voxel accuracies on 256 voxels.
6. Subjects of 40 epochs (E=80, 2048 + 512 voxels): ``run('svm')``
   through K1's multi-tile tensor-core kernel alone (its voxel
   accuracies against plain printed beside those of fcma_corr.cu's
   K1 forced on the same 256 voxels), the host-CV branch through K3's
   long-subject tensor-core kernel alone (its accuracies on 128 voxels
   against those of the plain K3, printed beside those of
   fcma_corr.cu's K3 forced) and a portioned ``Classifier`` fit
   through K4 (the multi-tile tensor-core kernel alone: three sample
   tiles), each held against its plain path.
7. The FCMA face-scene study's design at whole brain: 18 subjects x 12
   epochs of 12 TRs (E=216, 2 conditions x 6), 64x64x16 volume,
   mask1 = 1024 voxels, mask2 = the whole volume, 18 folds;
   ``prepare_fcma_data`` then ``run('svm')`` (SMO budget
   ``STUDY_SVM_ITERS``), which must launch K1 through its slab route
   alone; warm seconds, the profiled device time by kernel, peak device
   memory, and kernel-vs-plain accuracies on 256 voxels, beside those
   of fcma_corr.cu's K1 forced.  Then its stage 2: a portioned
   ``Classifier`` fit on all 216 samples (mask1 x the whole volume, 128
   voxels a portion, groups of 12), the last subject held out, which
   must launch K4 through its slab route alone (8 slabs a fit); warm
   fit seconds, the stacking and upload seconds, peak device memory,
   its test similarities and predictions held against the plain fit,
   and a held-out accuracy of at least 0.75.
8. K5, the SUMMA ring step, against its plain version (``mma_update``)
   on z-scored inputs, through the tensor-core kernel that every call
   takes (ring_mma_tc.cu: a pre-pass splits the operands, then 3xTF32
   wgmma; timed on operands split once, as the ring splits them), at
   (a) T=600, n_local=B=65536, one shard, the panel being the
   resident block (the whole-brain one-card ring's Gram, a 17.2 GB
   block), and on the same inputs through ring_mma.cu's FMA kernel
   forced (route="ffma"), with the card's SM clock and power sampled
   while the tensor-core kernel and cuBLAS run; (b) T=600,
   n_local=B=16384, owner 2 of 4 (one step of the 4-position ring,
   the other three blocks held bit-identical to a sentinel); (c)
   T=7, n_local=130, B=67, owner 1 of 3 with a NaN column (ragged
   edges; both kernels); at T=600, n_local=B=8192 with a panel of its
   own (path C's step); and on unnormalized inputs (scales 1e3 and
   1e-3) against the float64 product, within four times the fp32
   product's error.  The pre-pass kernel's hi and lo are held
   bit-identical to ``split_kmajor`` (row ``ring_split``).
9. Ring path A: ``distla.gram`` of one whole-brain subject (T=600,
   V=65,536) on the one-card mesh at the default 8 GiB budget, which
   the 17.3 GB working set exceeds, so the ring runs (one K5 launch,
   which must take the tensor-core kernel, and one split of its one
   operand); held against the plain product in row slabs; warm
   seconds, K5's device time in a profiled run, peak device memory
   with the split buffers.
10. Ring path B: the same data on a 4-position mesh of the one card
   (16 K5 launches, owners other than 0, all on the tensor-core
   kernel, and 4 splits: each shard once), held against path A.
11. Ring path C: leave-one-out ``isfc(data, mesh=...)`` of 8 subjects
   x 600 TRs x 8,192 voxels (planted shared signal) on the one-card
   mesh (8 K5 launches, all on the tensor-core kernel, 16 splits),
   held against ``isfc(data)`` without a mesh; ``isc`` leave-one-out
   and pairwise on the same data.
12. The ingest split: one ``normalize_epochs`` call on 32 whole-brain
   epochs, split into host stack, upload, K2 and download (last, so
   that its pinned buffer, which PyTorch's host allocator keeps, is
   not there while the paths above are timed).

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
PEAK_TF32_FLOPS = 494.7e12  # H100 SXM, TF32 tensor cores, dense
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
# K4 and the stage-2 test similarities, two readings.  Entries within
# a sample group are of the order of K[0, 0] ~ V1 V2, those across
# groups of its square root, which at 65536 x 1024 is 1.2e-4 of K[0, 0]:
# so every entry is held to 1e-5 of K[0, 0] (f32 accumulation order of
# the large entries), and the cross-group entries, where a wrong
# product would show, to 1e-3 of their own RMS.
K4_RTOL = 1e-5
K4_XTOL = 1e-3
ACC_AGREE = 0.95    # share of voxels whose accuracies are equal
# SMO budget a sample of the study path (VoxelSelector's default is 10):
# the eager SMO takes svm_iters x 216 steps on each of 14 chunks of 76
# voxels, each step about 80 host launches, so a run('svm') takes about
# 4 s of host time per unit of svm_iters; K1 does not depend on it
STUDY_SVM_ITERS = 2
STAGE2_ACC = 0.75   # held-out accuracy of stage 2 on the planted data
# K5 and the ring paths: entries are Pearson r in [-1, 1] of z-scored
# columns; f32 sums over T in another order than cuBLAS's
K5_ATOL = 1e-5
RING_AB_ATOL = 1e-6  # path B vs path A: the same kernel, per-shard z
ISFC_ATOL = 1e-5     # ring ISFC vs the dense torch.matmul path


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def k2_launches(label):
    """K2's launches since the last reset, all and by route; fails
    unless the tile route took every one, at least one."""
    from brainiak_tpu_torch.ops.kernels import epoch_norm as en

    out = {"epoch_zscore": en.launches(),
           "epoch_zscore_tile": en.launches("tile"),
           "epoch_zscore_simple": en.launches("simple")}
    if out["epoch_zscore"] < 1 or \
            out["epoch_zscore_tile"] != out["epoch_zscore"]:
        fail(f"{label}: K2 did not run on its tile route alone: {out}")
    return out


def bound_ms(n_bytes, n_flops, n_tf32_flops=0):
    """The least time for the work: bytes over the memory rate, or the
    fp32 and TF32 operations each over its peak rate, the larger."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = n_flops / PEAK_FP32_FLOPS + n_tf32_flops / PEAK_TF32_FLOPS
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
            k = re.search(r"([a-z_]+_kernel)(I[fd]?(?:L[ib]\d+E)*E)?",
                          m.group(1))
            args = re.findall(r"L[ib](\d+)E|([fd])", k.group(2) or "")
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


def stage_ms(torch, fn, names):
    """Device milliseconds and launches of one warm fn(), summed by
    stage: ``names`` holds tuples (stage, C entry point names...), and
    each call of such an entry point (``fcma_kernels._fn``) is timed
    by CUDA events recorded just before and after it on the stream it
    launches on, the kernels it launches itself included.  Returns
    ``{stage: ms}`` and ``{stage: calls}``, (None, None) where none was
    called.  Events, not ``torch.profiler``: the profiler left out
    kernels of the slab routes here (one of 8 correlation launches, at
    times a whole stage), warm-up step or not."""
    from brainiak_tpu_torch.ops import fcma_kernels as fk

    fn()
    torch.cuda.synchronize()
    spans = []  # (stage, start event, stop event)
    entry = fk._fn

    def timed(source, name):
        launch = entry(source, name)
        stage = next((g[0] for g in names if name in g[1:]), None)
        if stage is None:
            return launch

        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            err = launch(*args)
            stop.record()
            spans.append((stage, start, stop))
            return err
        return call

    fk._fn = timed
    try:
        fn()
    finally:
        fk._fn = entry
    torch.cuda.synchronize()
    out = {group[0]: 0.0 for group in names}
    seen = {group[0]: 0 for group in names}
    for stage, start, stop in spans:
        out[stage] += start.elapsed_time(stop)
        seen[stage] += 1
    return (out, seen) if spans else (None, None)


def check_k1(torch, blk, data, eps, reps, alt_ept=None, ffma_reps=None):
    """K1 against its plain version (blocks of 128 voxels) on blk
    [E, T, B] and data [E, T, V]: the path's route and, where that is a
    tensor-core route (fcma_gram_tc.cu on one epoch tile,
    fcma_gram_tcm.cu on more up to 104 epochs, beyond that the slabs of
    route "tcs": K3's fcma_corr_tc.cu or fcma_corr_tcl.cu's raw mode,
    then fcma_gram_tcs.cu), fcma_corr.cu's FMA kernel forced on the
    same inputs (timed over ``ffma_reps``, by default ``reps``).
    ``{route: row of its figures}``; a "tcs" row gives its two stages'
    device times too.  With ``alt_ept`` the path's route at the other
    epoch tiling is checked and timed too."""
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
    route = fk.gram_route(n_e, eps)[0]
    runs = [(route, None, lambda: fk.fcma_gram(blk, data, eps))]
    if route != "ffma":
        runs.append(("ffma", None, lambda: fk._kernel_gram(
            blk, data, eps, route="ffma")))
    if alt_ept is not None:
        runs.append((route, alt_ept, lambda: fk._kernel_gram(
            blk, data, eps, ept=alt_ept, route=route)))
    rows = {}
    witness = {}  # the slab route's worst voxel: every route's Gram of it
    for name, ept, fn in runs:
        got = fn()
        rel = ((got - want).abs() / want[:, :1, :1].abs()).max().item()
        if name == "tcs":
            worst = int(((got - want).abs() / want[:, :1, :1].abs()).amax(
                dim=(1, 2)).argmax())
            witness["plain"] = want[worst].clone()
        if witness and ept is None:
            witness[name] = got[worst].clone()
        err = (got - want).abs().max().item()
        label = f"fcma_gram[{name}" + ("" if ept is None else
                                       f", ept={ept}") + "]"
        log(f"K1 {label} E={n_e} T={n_t} B={n_b} V={n_v} max_abs_err "
            f"{err:.3e} max err/K[0,0] {rel:.3e} (rtol {K1_RTOL})")
        if not rel <= K1_RTOL:
            fail(f"K1 ({label}) disagrees with its plain version")
        # the check's run warmed it up
        ms = cuda_ms(torch, fn, (ffma_reps or reps) if name == "ffma"
                     else reps, warmup=0)
        del got
        if ept is None:
            rows[name] = {"max_abs_err": err, "ms": ms}
        else:
            log(f"  K1 [{name}] at E={n_e}: ept="
                f"{fk.epoch_tiles(n_e, eps)[0]} (the path's) "
                f"{rows[name]['ms']:.3f} ms, ept={ept} {ms:.3f} ms")
    corr = 2 * n_e * n_t * n_b * n_v
    gram = gram_flops(n_e, n_t, n_b, n_v) - corr
    n_bytes = 4 * (n_e * n_t * (n_b + n_v) + n_b * n_e * n_e)
    del want
    torch.cuda.empty_cache()
    if witness:
        # float64 from the inputs up: r, Fisher-z, the z-score (its
        # variance in two passes) and the Gram of that voxel
        r = torch.einsum('et,etv->ev', blk[:, :, worst].double(),
                         data.double())
        z = (0.5 * torch.log((1 + r) / (1 - r))).reshape(
            n_e // eps, eps, n_v)
        z = (z - z.mean(dim=1, keepdim=True)) / z.std(
            dim=1, keepdim=True, correction=0)
        z = z.reshape(n_e, n_v)
        exact = z @ z.T
        errs = {k: ((g.double() - exact).abs().max()
                    / exact[0, 0].abs()).item() for k, g in witness.items()}
        log(f"  K1 at E={n_e}, block voxel {worst} (the slab route's "
            "largest difference from plain) against float64, err/K[0,0]: "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
        del r, z, exact
    common = dict(plain_ms=cuda_ms(torch, plain, 1),
                  library_ms=cuda_ms(torch, library, 1))
    for name, row in rows.items():
        b_ms, b_by = (bound_ms(n_bytes, corr + gram) if name == "ffma"
                      else bound_ms(n_bytes, 0, 3 * (corr + gram))
                      if name == "tcs"
                      else bound_ms(n_bytes, gram, 3 * corr))
        row.update(common, bound_ms=b_ms, bound_by=b_by)
    if route == "tcs":
        tc = rows[route]
        parts, seen = stage_ms(torch, runs[0][2], (
            ("corr", "fcma_corr_normalize_tc_f32",
             "fcma_corr_fisher_tcl_f32"),
            ("gram", "fcma_gram_tcs_f32")))
        tc["corr_ms"], tc["gram_ms"] = (parts["corr"], parts["gram"]) \
            if parts else (None, None)
        slab_ms = 1e3 * 2 * 4 * n_b * n_e * n_v / PEAK_BYTES
        log(f"  K1 at E={n_e} eps={eps} T={n_t} B={n_b} V={n_v}: slabs "
            f"[tcs] {tc['ms']:.3f} ms (" + (
                f"correlation {parts['corr']:.3f} ms, Gram "
                f"{parts['gram']:.3f} ms in one call, CUDA events "
                f"around each launch: {seen}"
                if parts else "stages not measured") +
            f"; bound {tc['bound_ms']:.3f} ms, {tc['bound_by']}, all "
            f"3xTF32; slab written and read once {slab_ms:.3f} ms), FMA "
            f"{rows['ffma']['ms']:.3f} ms (fp32 bound "
            f"{rows['ffma']['bound_ms']:.3f} ms), cuBLAS fp32 "
            f"{common['library_ms']:.3f} ms, plain "
            f"{common['plain_ms']:.3f} ms; slabs / FMA "
            f"{tc['ms'] / rows['ffma']['ms']:.3f}, / cuBLAS "
            f"{tc['ms'] / common['library_ms']:.3f}, bound / slabs "
            f"{tc['bound_ms'] / tc['ms']:.3f}")
    elif route != "ffma":
        tc = rows[route]
        fp32_ms = bound_ms(n_bytes, corr + gram)[0]
        log(f"  K1 at E={n_e} B={n_b} V={n_v}: tensor-core [{route}] "
            f"{tc['ms']:.3f} ms (bound {tc['bound_ms']:.3f}"
            f" ms, 3xTF32 + fp32 Gram), FMA {rows['ffma']['ms']:.3f} ms "
            f"(fp32 bound {fp32_ms:.3f} ms), cuBLAS fp32 "
            f"{common['library_ms']:.3f} ms; tensor-core / FMA "
            f"{tc['ms'] / rows['ffma']['ms']:.3f}, / cuBLAS "
            f"{tc['ms'] / common['library_ms']:.3f}")
    return rows


def k3_zerr(torch, got, want, blk, data, eps):
    """Largest |got - want|, and largest times the std of each subject
    group's Fisher-z values (the K3 rule), over [B, E, V]."""
    from brainiak_tpu_torch.ops.correlation import correlate_epochs
    from brainiak_tpu_torch.ops.fisherz import fisher_z

    n_b, n_e, n_v = got.shape
    z = fisher_z(correlate_epochs(blk.transpose(1, 2),
                                  data.transpose(1, 2)))
    zr = z.reshape(n_b, n_e // eps, eps, n_v)
    var = (zr * zr).mean(dim=2, keepdim=True) - \
        zr.mean(dim=2, keepdim=True) ** 2
    del z
    sigma = var.clamp(min=0).sqrt().expand_as(zr).reshape(got.shape)
    diff = (got - want).abs()
    return diff.max().item(), (diff * sigma).max().item(), \
        (diff > 1e-4).float().mean().item()


def check_k3(torch, blk, data, eps, reps):
    """K3 against its plain version: the path's route (a tensor-core
    kernel: fcma_corr_tc.cu up to 4 epochs a subject, fcma_corr_tcl.cu
    beyond) and fcma_corr.cu's FMA kernel forced on the same inputs.
    ``{route: row of its figures}``.  The difference is held in
    Fisher-z units: times the std of each subject group's Fisher-z
    values."""
    from brainiak_tpu_torch.ops import fcma_kernels as fk

    n_e, n_t, n_b = blk.shape
    n_v = data.shape[2]
    want = fk.fcma_corr_normalize_plain(blk, data, eps)
    route = fk.corr_route(n_e, eps)
    routes = [route, "ffma"]
    rows = {}
    for name in routes:
        got = fk._kernel_corr_normalize(blk, data, eps, route=name)
        err, zerr, share = k3_zerr(torch, got, want, blk, data, eps)
        del got
        log(f"K3 fcma_corr_normalize[{name}] E={n_e} eps={eps} T={n_t} "
            f"B={n_b} V={n_v} max_abs_err {err:.3e} max err*sigma "
            f"{zerr:.3e} (tol {K3_ZTOL}); share of |err| > 1e-4: "
            f"{share:.2e}")
        if not zerr <= K3_ZTOL:
            fail(f"K3 ({name}, E={n_e}, eps={eps}, B={n_b}) disagrees "
                 "with its plain version")
        rows[name] = {"max_abs_err": err, "ms": cuda_ms(
            torch, lambda: fk._kernel_corr_normalize(blk, data, eps,
                                                     route=name), reps)}
    del want
    torch.cuda.empty_cache()
    corr = 2 * n_e * n_t * n_b * n_v
    n_bytes = 4 * (n_e * n_t * (n_b + n_v) + n_b * n_e * n_v)
    common = dict(
        plain_ms=cuda_ms(torch, lambda: fk.fcma_corr_normalize_plain(
            blk, data, eps), 2),
        library_ms=cuda_ms(torch, lambda: torch.einsum(
            'etb,etv->bev', blk, data), reps))
    for name, row in rows.items():
        b_ms, b_by = (bound_ms(n_bytes, corr) if name == "ffma"
                      else bound_ms(n_bytes, 0, 3 * corr))
        row.update(common, bound_ms=b_ms, bound_by=b_by)
    tc = rows[route]
    log(f"  K3 at E={n_e} eps={eps} B={n_b} V={n_v}: tensor-core "
        f"[{route}] {tc['ms']:.3f} ms (bound {tc['bound_ms']:.3f} ms, "
        f"{tc['bound_by']}), FMA {rows['ffma']['ms']:.3f} ms (bound "
        f"{rows['ffma']['bound_ms']:.3f} ms), cuBLAS fp32 "
        f"{common['library_ms']:.3f} ms; tensor-core / FMA "
        f"{tc['ms'] / rows['ffma']['ms']:.3f}, / cuBLAS "
        f"{tc['ms'] / common['library_ms']:.3f}")
    return rows


def k4_errors(got, want, k00, cross):
    """The largest |got - want| over K[0, 0], and the largest over the
    entries ``cross`` (a mask) over those entries' RMS in ``want``."""
    diff = np.abs(got - want)
    rms = np.sqrt(np.mean(want[cross] ** 2))
    return diff.max() / abs(k00), diff[cross].max() / rms


def check_k4_errors(what, errors):
    rel, xrel = errors
    log(f"  {what}: max err/K[0,0] {rel:.3e} (rtol {K4_RTOL}), max "
        f"cross-group err/RMS {xrel:.3e} (tol {K4_XTOL})")
    if not (rel <= K4_RTOL and xrel <= K4_XTOL):
        fail(f"{what} disagrees with the plain version")


def k4_float64(torch, x1, x2, norm_unit, chunk=16):
    """K4's Gram in float64 from the inputs up: r, and for norm_unit > 1
    its Fisher-z and the z-score over each group (its variance in two
    passes), in chunks of ``chunk`` voxels of the narrower region."""
    blk, data = (x2, x1) if x2.shape[2] < x1.shape[2] else (x1, x2)
    n = blk.shape[0]
    exact = torch.zeros((n, n), dtype=torch.float64, device=blk.device)
    for s in range(0, blk.shape[2], chunk):
        f = torch.einsum('ntb,ntv->bnv', blk[:, :, s:s + chunk].double(),
                         data.double())
        if norm_unit > 1:
            z = (0.5 * torch.log((1 + f) / (1 - f))).reshape(
                f.shape[0], n // norm_unit, norm_unit, -1)
            f = ((z - z.mean(dim=2, keepdim=True)) / z.std(
                dim=2, keepdim=True, correction=0)).reshape(f.shape)
            del z
        exact += torch.einsum('bnv,bmv->nm', f, f)
        del f
    return exact.cpu().numpy()


def check_k4(torch, x1, x2, norm_unit, reps, ffma_reps=None):
    """K4 against its plain version (blocks of 128 voxels of x1) on
    x1 [N, T, V1] and x2 [N, T, V2]: the path's route and, where that
    is a tensor-core route (fcma_sample_gram_tc.cu on one sample tile,
    fcma_sample_gram_tcm.cu on more up to 104 samples, beyond that the
    slabs of route "tcs": fcma_corr_tcl.cu's raw or r mode, then
    fcma_gram_tcs.cu, then fcma_sample_gram_tcs.cu's block-voxel sum)
    and fcma_sample_gram.cu's FMA kernel forced on the same inputs (timed
    over ``ffma_reps`` runs after the check's, by default ``reps``
    after a warm-up; 0: not run).
    ``{route: row of its figures}``; a "tcs" row gives its three
    stages' device times too, and the route, the FMA kernel and the
    plain version are each held to the float64 Gram (logged).  The
    cross-group entries are those of samples in different groups of
    ``norm_unit`` (of different samples for raw features)."""
    from brainiak_tpu_torch.ops import fcma_kernels as fk

    n, n_t, v1 = x1.shape
    v2 = x2.shape[2]
    chunk = 128
    group = np.arange(n) // max(norm_unit, 1)
    cross = group[:, None] != group[None, :]

    def plain():
        return fk.fcma_sample_gram_plain(x1, x2, norm_unit)

    def library():
        gram = torch.zeros((n, n), device=x1.device)
        for s in range(0, v1, chunk):
            corr = torch.einsum('ntb,ntv->nbv', x1[:, :, s:s + chunk], x2)
            feats = corr.reshape(n, -1)
            gram.addmm_(feats, feats.T)
        return gram

    want = plain().cpu().double().numpy()
    route = fk.sample_gram_route(n, norm_unit)[0]
    runs = [(route, lambda: fk.fcma_sample_gram(x1, x2, norm_unit))]
    ffma = ffma_reps != 0
    if route != "ffma" and ffma:
        runs.append(("ffma", lambda: fk._kernel_sample_gram(
            x1, x2, norm_unit, route="ffma")))
    rows = {}
    witness = {"plain": want}  # the slab route's: every Gram vs float64
    for name, fn in runs:
        got = fn().cpu().double().numpy()
        if route == "tcs":
            witness[name] = got
        err = float(np.abs(got - want).max())
        log(f"K4 fcma_sample_gram[{name}] N={n} T={n_t} V1={v1} V2={v2} "
            f"norm_unit={norm_unit} max_abs_err {err:.3e}")
        check_k4_errors(f"K4 [{name}] (N={n}, norm_unit={norm_unit})",
                        k4_errors(got, want, want[0, 0], cross))
        # a forced FMA run timed over ffma_reps: the check's run warmed
        # it up
        slow = name == "ffma" and ffma_reps is not None
        rows[name] = {"max_abs_err": err, "ms": cuda_ms(
            torch, fn, ffma_reps if slow else reps, warmup=int(not slow))}
    corr = 2 * n * n_t * v1 * v2
    gram = gram_flops(n, n_t, v1, v2) - corr
    n_bytes = 4 * (n * n_t * (v1 + v2) + n * n)
    torch.cuda.empty_cache()
    if route == "tcs":
        exact = k4_float64(torch, x1, x2, norm_unit)
        torch.cuda.empty_cache()
        log(f"  K4 at N={n} norm_unit={norm_unit} against float64, "
            "err/K[0,0]: " + ", ".join(
                f"{k} {np.abs(g - exact).max() / abs(exact[0, 0]):.3e}"
                for k, g in witness.items()))
    common = dict(plain_ms=cuda_ms(torch, plain, 1),
                  library_ms=cuda_ms(torch, library, 1))
    for name, row in rows.items():
        b_ms, b_by = (bound_ms(n_bytes, corr + gram) if name == "ffma"
                      else bound_ms(n_bytes, 0, 3 * (corr + gram))
                      if name == "tcs"
                      else bound_ms(n_bytes, gram, 3 * corr))
        row.update(common, bound_ms=b_ms, bound_by=b_by)
        log(f"  fcma_sample_gram[{name}] N={n} norm_unit={norm_unit}: ms "
            f"{row['ms']:.3f} plain_ms {row['plain_ms']:.3f} bound_ms "
            f"{b_ms:.3f} ({b_by}) library_ms {row['library_ms']:.3f}")
    if route == "tcs":
        tc = rows[route]
        parts, seen = stage_ms(torch, runs[0][1], (
            ("corr", "fcma_corr_fisher_tcl_f32", "fcma_corr_r_tcl_f32"),
            ("gram", "fcma_gram_tcs_f32"),
            ("sum", "fcma_sample_gram_tcs_sum_f32")))
        for key in ("corr", "gram", "sum"):
            tc[f"{key}_ms"] = parts[key] if parts else None
        b_n = min(v1, v2)
        slab_ms = 1e3 * 2 * 4 * b_n * n * max(v1, v2) / PEAK_BYTES
        beside = (f"FMA {rows['ffma']['ms']:.3f} ms (fp32 bound "
                  f"{rows['ffma']['bound_ms']:.3f} ms), " if ffma else "")
        log(f"  K4 at N={n} norm_unit={norm_unit} T={n_t} {v1} x {v2}: "
            f"slabs [tcs] {tc['ms']:.3f} ms (" + (
                f"correlation {parts['corr']:.3f} ms, Gram "
                f"{parts['gram']:.3f} ms, block-voxel sum "
                f"{parts['sum']:.3f} ms in one call, CUDA events around "
                f"each launch: {seen}"
                if parts else "stages not measured") +
            f"; bound {tc['bound_ms']:.3f} ms, {tc['bound_by']}, all "
            f"3xTF32; slab written and read once {slab_ms:.3f} ms), "
            f"{beside}cuBLAS fp32 {common['library_ms']:.3f} ms, plain "
            f"{common['plain_ms']:.3f} ms; slabs / cuBLAS "
            f"{tc['ms'] / common['library_ms']:.3f}, bound / slabs "
            f"{tc['bound_ms'] / tc['ms']:.3f}" + (
                f", slabs / FMA {tc['ms'] / rows['ffma']['ms']:.3f}"
                if ffma else ""))
    elif route != "ffma":
        tc = rows[route]
        log(f"  K4 at N={n} norm_unit={norm_unit} {v1} x {v2}: tensor-core "
            f"[{route}] {tc['ms']:.3f} ms (bound {tc['bound_ms']:.3f} ms, "
            f"3xTF32 + fp32 Gram), FMA {rows['ffma']['ms']:.3f} ms "
            f"(fp32 bound {rows['ffma']['bound_ms']:.3f} ms), cuBLAS fp32 "
            f"{common['library_ms']:.3f} ms; tensor-core / FMA "
            f"{tc['ms'] / rows['ffma']['ms']:.3f}, / cuBLAS "
            f"{tc['ms'] / common['library_ms']:.3f}")
    return rows


def check_k2(torch, en, rng, n, t, v, dev, reps=20):
    """K2 on [n, t, v] float32 (from rng, with a constant, a NaN and an
    inf column): its tile route (the one the paths take) within K2_ATOL
    of plain and the forced simple kernel's output bit for bit, those
    columns 0.  Times by CUDA events: tile and simple in turns (tile,
    simple, simple, tile), plain, and a copy of the same bytes
    (``torch.empty_like(x).copy_(x)``: the rate the card attains for
    one read and one write).  Returns the two rows (tile, simple)."""
    x = torch.from_numpy(
        rng.standard_normal((n, t, v), dtype=np.float32) * 3 + 1).to(dev)
    x[0, :, 5] = 2.5
    x[1, 3, 7] = float("nan")
    x[2, t - 1, 9] = float("inf")
    if en.zscore_route(t, x.dtype) != "tile":
        fail(f"K2 at T={t} does not take the tile route")
    got, want = en.batch_zscore(x), en.batch_zscore_plain(x)
    simple = en._kernel_zscore(x, "simple")
    err = (got - want).abs().max().item()
    err_simple = (simple - want).abs().max().item()
    same = torch.equal(got, simple)
    zeros = all(bool(torch.all(got[e, :, c] == 0))
                for e, c in ((0, 5), (1, 7), (2, 9)))
    del got, want, simple
    w = en.tile_width(t, x.dtype)
    log(f"K2 epoch_zscore [{n},{t},{v}] tile route (W={w}) max_abs_err "
        f"{err:.3e}, simple {err_simple:.3e} (atol {K2_ATOL}); tile == "
        f"simple bit for bit: {same}; constant, NaN and inf columns 0: "
        f"{zeros}")
    if not (err <= K2_ATOL and err_simple <= K2_ATOL and same and zeros):
        fail("K2 disagrees with its plain version or between its routes")
    tile_ms, simple_ms = [], []
    for timed in (tile_ms, simple_ms, simple_ms, tile_ms):
        route = "tile" if timed is tile_ms else "simple"
        timed.append(cuda_ms(torch, lambda: en._kernel_zscore(x, route),
                             reps))
    common = {
        "plain_ms": cuda_ms(torch, lambda: en.batch_zscore_plain(x), 5),
        "copy_ms": cuda_ms(torch, lambda: torch.empty_like(x).copy_(x),
                           reps),
        "library_ms": None}
    common["bound_ms"], common["bound_by"] = bound_ms(2 * x.numel() * 4,
                                                      8 * x.numel())
    tile = dict(common, max_abs_err=err, ms=sum(tile_ms) / 2, tile_w=w)
    simple = dict(common, max_abs_err=err_simple, ms=sum(simple_ms) / 2)
    log(f"  K2 at [{n},{t},{v}]: tile {tile['ms']:.3f} ms ("
        f"{tile_ms[0]:.3f}, {tile_ms[1]:.3f}), simple {simple['ms']:.3f} "
        f"ms ({simple_ms[0]:.3f}, {simple_ms[1]:.3f}), plain "
        f"{common['plain_ms']:.3f} ms, copy of the same bytes "
        f"{common['copy_ms']:.3f} ms, bound {common['bound_ms']:.3f} ms "
        f"({common['bound_by']}); bound / tile "
        f"{common['bound_ms'] / tile['ms']:.3f}, copy / tile "
        f"{common['copy_ms'] / tile['ms']:.3f}, tile / simple "
        f"{tile['ms'] / simple['ms']:.3f}")
    return tile, simple


def run_ingest_split(torch, dev, n=32, t=150, v=65536):
    """One ``normalize_epochs`` call on n whole-brain epochs [t, v]
    float32 (mask2's batch in the whole-brain path), timed whole, then
    its steps one by one as the function takes them: the host stack,
    the upload from pageable memory, K2 and the download; and an
    upload from a pinned buffer beside them (the copy into it timed
    apart).  Host clock, each step ending in a synchronize."""
    from brainiak_tpu_torch.ops.kernels import epoch_norm as en

    rng = np.random.default_rng(SEED + 6)
    mats = list(rng.standard_normal((n, t, v), dtype=np.float32))
    nbytes = n * t * v * 4
    en.normalize_epochs(mats[:1])  # the library loaded
    en.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = en.normalize_epochs(mats)
    t_whole = time.perf_counter() - t0
    tile = en.launches("tile")
    if en.launches() != 1 or tile != 1:
        fail(f"normalize_epochs launched K2 {en.launches()} times, "
             f"{tile} on the tile route: one tile launch expected")
    stamps = [time.perf_counter()]
    stacked = np.stack(mats)
    stamps.append(time.perf_counter())
    batch = torch.from_numpy(stacked).to(dev)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    out = en.batch_zscore(batch)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    res = out.cpu().numpy()
    stamps.append(time.perf_counter())
    if not np.array_equal(res[n - 1], whole[n - 1]):
        fail("the timed steps of normalize_epochs gave other bits")
    del batch, out, res, whole
    t0 = time.perf_counter()
    pinned = torch.from_numpy(stacked).pin_memory()
    t_pin = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = pinned.to(dev, non_blocking=True)
    torch.cuda.synchronize()
    t_up_pinned = time.perf_counter() - t0
    del batch, pinned, stacked
    stack, up, k2, down = (b - a for a, b in zip(stamps, stamps[1:]))
    log(f"ingest split, normalize_epochs of {n} epochs [{t}, {v}] "
        f"float32 ({nbytes / 1e9:.3f} GB): whole call {t_whole:.4f} s; "
        f"host stack {stack:.4f} s, upload {up:.4f} s "
        f"({nbytes / up / 1e9:.2f} GB/s, pageable), K2 {1e3 * k2:.3f} "
        f"ms (host clock, launch included), download {down:.4f} s "
        f"({nbytes / down / 1e9:.2f} GB/s); from a pinned buffer the "
        f"upload takes {t_up_pinned:.4f} s "
        f"({nbytes / t_up_pinned / 1e9:.2f} GB/s), the copy into it "
        f"{t_pin:.4f} s")


def phase_kernels(torch, dev):
    from brainiak_tpu_torch.ops.kernels import epoch_norm as en

    rng = np.random.default_rng(SEED)
    rows = {}

    # K2 at the whole-brain ingest shape (mask2's batch), then at the
    # study's (its own seed, so the other kernels' inputs stay as they
    # were)
    rows["epoch_zscore"], rows["epoch_zscore_simple"] = check_k2(
        torch, en, rng, 32, 150, 65536, dev)
    rows["epoch_zscore_e216"], rows["epoch_zscore_e216_simple"] = check_k2(
        torch, en, np.random.default_rng(SEED + 5), 216, 12, 65536, dev)
    torch.cuda.empty_cache()

    # K1 at the whole-brain main-path shape (two-mask inputs)
    n_e, n_t, n_b, n_v, eps = 32, 150, 1024, 65536, 4
    data = normalized_epochs(torch, rng, n_e, n_t, n_v, dev)
    blk = normalized_epochs(torch, rng, n_e, n_t, n_b, dev)
    k1 = check_k1(torch, blk, data, eps, 3)
    rows["fcma_gram"], rows["fcma_gram_ffma"] = k1["tc"], k1["ffma"]

    # K1 at the one-mask path's shape (E=16: the 16-epoch tiling),
    # with the 32-epoch tiling forced on the same inputs for comparison
    blk16 = normalized_epochs(torch, rng, 16, n_t, 8192, dev)
    data16 = normalized_epochs(torch, rng, 16, n_t, 8192, dev)
    k1 = check_k1(torch, blk16, data16, eps, 5, alt_ept=32)
    rows["fcma_gram_e16"], rows["fcma_gram_ffma_e16"] = k1["tc"], k1["ffma"]
    del blk16, data16
    torch.cuda.empty_cache()

    # K3 at the host-CV branch's block shapes: B=128 (the path's
    # voxel_unit below) with both kernels, and the default voxel_unit
    k3 = check_k3(torch, blk[:, :, :128].contiguous(), data, eps, 5)
    rows["fcma_corr_normalize"] = k3["tc"]
    rows["fcma_corr_normalize_ffma"] = k3["ffma"]
    rows["fcma_corr_normalize_b256"] = check_k3(
        torch, blk[:, :, :256].contiguous(), data, eps, 5)["tc"]
    del blk, data
    torch.cuda.empty_cache()

    # K4 at the classifier path's shape: x1 the wider region, as
    # Classifier passes it; (b) raw features; (c) four sample tiles, the
    # multi-tile tensor-core kernel
    x2 = normalized_epochs(torch, rng, 32, n_t, 1024, dev)
    x1 = normalized_epochs(torch, rng, 32, n_t, 65536, dev)
    k4 = check_k4(torch, x1, x2, 4, 3)
    rows["fcma_sample_gram"], rows["fcma_sample_gram_ffma"] = \
        k4["tc"], k4["ffma"]
    k4 = check_k4(torch, x1, x2, 0, 3)
    rows["fcma_sample_gram_raw"], rows["fcma_sample_gram_raw_ffma"] = \
        k4["tc"], k4["ffma"]
    del x1, x2
    torch.cuda.empty_cache()
    x2 = normalized_epochs(torch, rng, 96, n_t, 1024, dev)
    x1 = normalized_epochs(torch, rng, 96, n_t, 8192, dev)
    k4 = check_k4(torch, x1, x2, 12, 3)
    rows["fcma_sample_gram_n96"], rows["fcma_sample_gram_n96_ffma"] = \
        k4["tcm"], k4["ffma"]
    del x1, x2
    torch.cuda.empty_cache()

    # subjects of 40 epochs, two epoch tiles each: K1's multi-tile
    # tensor-core kernel (all 80 epochs of a block at once) and K3's
    # long-subject one, each beside the FMA one; K4 through its
    # multi-tile tensor-core kernel, beside the FMA one's statistics pass
    n_e, eps = 80, 40
    data = normalized_epochs(torch, rng, n_e, n_t, 4096, dev)
    blk = normalized_epochs(torch, rng, n_e, n_t, 512, dev)
    k1 = check_k1(torch, blk, data, eps, 3)
    rows["fcma_gram_e80"], rows["fcma_gram_e80_ffma"] = k1["tcm"], k1["ffma"]
    k3 = check_k3(torch, blk[:, :, :128].contiguous(), data, eps, 5)
    rows["fcma_corr_normalize_e80"] = k3["tcl"]
    rows["fcma_corr_normalize_e80_ffma"] = k3["ffma"]
    k4 = check_k4(torch, data, blk, eps, 3)
    rows["fcma_sample_gram_n80"], rows["fcma_sample_gram_n80_ffma"] = \
        k4["tcm"], k4["ffma"]
    del blk, data
    torch.cuda.empty_cache()

    # K3 with subjects of 12 epochs, three whole chunks of 4 each
    data = normalized_epochs(torch, rng, 96, n_t, 16384, dev)
    blk = normalized_epochs(torch, rng, 96, n_t, 128, dev)
    rows["fcma_corr_normalize_e96"] = check_k3(torch, blk, data, 12,
                                               5)["tcl"]
    del blk, data
    torch.cuda.empty_cache()

    # K1 beyond 104 epochs, the slab route "tcs": E=216 of 12 a subject
    # at T=12 (the study path's shape: K3's long-subject body in its raw
    # mode, then the Gram z-scoring as it loads), and E=128 of 4 a
    # subject at K1's E=80 widths (K3's short-subject body); each beside
    # the FMA kernel forced, timed over fewer runs
    for n_e, eps, n_t, n_b, n_v, name in (
            (216, 12, 12, 1024, 65536, "fcma_gram_e216"),
            (128, 4, 150, 512, 4096, "fcma_gram_e128")):
        data = normalized_epochs(torch, rng, n_e, n_t, n_v, dev)
        blk = normalized_epochs(torch, rng, n_e, n_t, n_b, dev)
        k1 = check_k1(torch, blk, data, eps, 3, ffma_reps=1)
        rows[name], rows[name + "_ffma"] = k1["tcs"], k1["ffma"]
        del blk, data
        torch.cuda.empty_cache()

    # K4 beyond 104 samples, the slab route "tcs": N=216 in groups of 12
    # at T=12, 1024 x 65536 (the study's stage 2: fcma_corr_tcl.cu's raw
    # mode), beside the FMA kernel forced (timed over one run); N=128 in
    # groups of 4 at K1's E=80 widths (the group length that would take
    # K3's "tc" body), beside the FMA kernel; raw features there (the r
    # mode)
    for n, unit, n_t, v1, v2, name, ffma_reps in (
            (216, 12, 12, 1024, 65536, "fcma_sample_gram_n216", 1),
            (128, 4, 150, 512, 4096, "fcma_sample_gram_n128", None),
            (128, 0, 150, 512, 4096, "fcma_sample_gram_n128_raw", 0)):
        x1 = normalized_epochs(torch, rng, n, n_t, v1, dev)
        x2 = normalized_epochs(torch, rng, n, n_t, v2, dev)
        k4 = check_k4(torch, x1, x2, unit, 3, ffma_reps=ffma_reps)
        rows[name] = k4["tcs"]
        if ffma_reps != 0:
            rows[name + "_ffma"] = k4["ffma"]
        del x1, x2
        torch.cuda.empty_cache()
    for name, row in rows.items():
        log(f"  {name}: ms {row['ms']:.3f} plain_ms {row['plain_ms']:.3f} "
            f"bound_ms {row['bound_ms']:.3f} ({row['bound_by']}) "
            f"library_ms {row['library_ms']}")
    return rows


def synthetic_images(rng, n_subj, shape, n_trs, planted_b, planted_v,
                     epoch_len=150):
    """Images [x, y, z, T] with a condition-1 coupling between the
    flat voxels ``planted_b`` and ``planted_v``, and condition specs:
    epochs of ``epoch_len`` TRs alternate condition 0 and 1."""
    n_vox = int(np.prod(shape))
    n_ep = n_trs // epoch_len
    images, conditions = [], []
    for _ in range(n_subj):
        data = rng.standard_normal((n_vox, n_trs), dtype=np.float32)
        shared = rng.standard_normal(n_trs, dtype=np.float32)
        cond = np.zeros((2, n_ep // 2, n_trs), dtype=np.int64)
        for k in range(n_ep):
            sl = slice(epoch_len * k, epoch_len * (k + 1))
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


def compare_with_plain(torch, vs, accs, n_check, label="kernel",
                       gate=True):
    """Kernel-path accuracies of the first n_check voxels against the
    plain path (plain Gram, same shrink and batched SVM CV); ``gate``:
    fail below ACC_AGREE or beyond one test sample a fold."""
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
    log(f"  {label} vs plain accuracies on {n_check} voxels: equal on "
        f"{same:.4f}, max diff {worst:.4f} (one test sample per fold "
        f"= {one_sample:.4f})")
    if gate and (same < ACC_AGREE or worst > one_sample + 1e-6):
        fail(f"{label} accuracies disagree with the plain path")


def forced_route_accuracies(torch, vs, n_check, route):
    """Accuracies of the first n_check voxels with K1 forced onto
    ``route``, with run('svm')'s shrink and batched SVM CV."""
    from brainiak_tpu_torch.fcma.voxelselector import _shrink
    from brainiak_tpu_torch.ops import fcma_kernels as fk
    from brainiak_tpu_torch.ops.svm import svm_cv_accuracy

    data1, data2 = vs._stack()
    grams = _shrink(fk._kernel_gram(vs._slice_block(data1, 0, n_check),
                                    data2, vs.epochs_per_subj,
                                    route=route))
    return svm_cv_accuracy(grams, vs.labels, vs.num_folds, C=vs.svm_C,
                           n_iters=vs.svm_iters, device=vs.device)


K1_KERNELS = ("fcma_gram_tc_kernel", "fcma_gram_kernel")


def device_events(torch, prof):
    """``[(name, (microseconds, count))]`` of the device activities of a
    finished profiler cycle, summed by name, from its raw events:
    without the tree of Python events that ``key_averages`` builds,
    which takes minutes for the half a million launches of a run of the
    SMO loop at 216 epochs (``run_study``).  The step annotation, which
    also shows as a device-side range, is left out."""
    sums = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA or \
                ev.name().startswith("ProfilerStep"):
            continue
        us, n = sums.get(ev.name(), (0.0, 0))
        sums[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
    return list(sums.items())


def profile_run(torch, vs, label, t_warm, top=6, k1_kernels=K1_KERNELS,
                raw=False):
    """Two more warm ``run('svm')`` under ``torch.profiler``, the first
    a profiler warm-up step: device time by kernel in the second, its
    number of kernel launches, and the device's busy share of its
    host-clock window and of the unprofiled warm run (``t_warm`` s).
    ``raw``: summed from the profiler's raw events (``device_events``),
    not its ``key_averages``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def device_averages(p):
        # the step annotation also shows as a device-side range
        return [(ev.key, (ev.self_device_time_total, ev.count))
                for ev in p.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA and
                not ev.key.startswith("ProfilerStep")]

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    traced = []   # the active step's device events, kept when ready
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.extend(
                     device_events(torch, p) if raw
                     else device_averages(p))) as prof:
        vs.run('svm')
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        vs.run('svm')
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
        prof.step()
    kernels = [(us, n, name) for name, (us, n) in traced]
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
    for kernel in k1_kernels:
        k1 = [(us, n) for us, n, name in kernels if kernel in name]
        log(f"    K1 {kernel} in the trace: " + (
            f"{sum(us for us, _ in k1) / 1e3:.3f} ms, "
            f"{sum(n for _, n in k1)}x" if k1 else "not seen"))


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
    launches = dict(fk.launches(), **k2_launches(label))
    n_sel = vs.num_voxels
    if launches["fcma_gram"] < 1:
        fail(f"{label}: the main path did not run K1: {launches}")
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
    fit/predict/decision_function/score interface: the class whose
    training samples have the largest mean kernel value (less half the
    class's mean Gram)."""

    kernel = "precomputed"

    def fit(self, k_train, y):
        self.classes_ = np.unique(y)
        self.y_ = np.asarray(y)
        self.offset_ = np.array([
            0.5 * k_train[np.ix_(self.y_ == c, self.y_ == c)].mean()
            for c in self.classes_])
        return self

    def _scores(self, k_test):
        means = np.stack([k_test[:, self.y_ == c].mean(axis=1)
                          for c in self.classes_], axis=1)
        return means - self.offset_

    def decision_function(self, k_test):
        scores = self._scores(k_test)
        return scores[:, 1] - scores[:, 0]

    def predict(self, k_test):
        return self.classes_[np.argmax(self._scores(k_test), axis=1)]

    def score(self, k_test, y):
        return float(np.mean(self.predict(k_test) == np.asarray(y)))


def compare_classifier_with_plain(torch, clf, pairs, labels, n_train):
    """A portioned fit's test similarities against the same fit through
    K4's plain version (before the shrink), and its predictions against
    those of an estimator fitted on the plain Gram.  The test block
    pairs held-out subjects with training ones: every entry of it is
    a cross-group entry."""
    from brainiak_tpu_torch.ops.fcma_kernels import fcma_sample_gram_plain

    x1, x2, _, _ = clf._stack_pairs(pairs)
    plain = fcma_sample_gram_plain(x1, x2, clf.epochs_per_subj)
    plain = plain.cpu().double().numpy()
    scale = 10.0 ** min(0, 2 - clf.num_digits_)
    test = plain[n_train:, :n_train]
    errors = k4_errors(clf.test_data_ / scale, test, plain[0, 0],
                       np.ones(test.shape, dtype=bool))
    ref = _KernelNearestMean().fit(plain[:n_train, :n_train] * scale,
                                   labels[:n_train])
    same = np.array_equal(ref.predict(test * scale), clf.predict())
    log(f"  K4 fit vs plain fit: predictions equal: {same}")
    check_k4_errors("the K4 fit's test similarities", errors)
    if not same:
        fail("the K4 fit's predictions differ from the plain fit's")


def run_stage2(torch, label, clf_kw, train, labels_train, test, y_test,
               fit_kw=None):
    """Fit twice (cold, warm) and predict twice; the warm seconds (and
    those of the fit's stacking and upload of the epochs alone), the
    peak device memory and the held-out accuracy.  ``test`` None: the
    test samples were given to fit (num_training_samples)."""
    from brainiak_tpu_torch.fcma import Classifier

    torch.cuda.reset_peak_memory_stats()
    times = {}
    for _ in range(2):
        t0 = time.perf_counter()
        clf = Classifier(_KernelNearestMean(), device="cuda", **clf_kw)
        clf.fit(train, labels_train, **(fit_kw or {}))
        torch.cuda.synchronize()
        times["fit"] = time.perf_counter() - t0
    for _ in range(2):
        t0 = time.perf_counter()
        pred = clf.predict(test)
        times["predict"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    clf._stack_pairs(train)
    torch.cuda.synchronize()
    times["stack"] = time.perf_counter() - t0
    dec = np.asarray(clf.decision_function(test))
    acc = clf.score(test, y_test)
    if pred.shape != (len(y_test),) or dec.shape != (len(y_test),) or \
            not np.all(np.isfinite(dec)):
        fail(f"{label}: predictions or decision values are not "
             f"{len(y_test)} finite values")
    log(f"stage 2, {label}: warm fit {times['fit']:.3f} s (stacking "
        f"and uploading the epochs alone {times['stack']:.3f} s), warm "
        f"predict {times['predict']:.4f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, held-out "
        f"accuracy {acc:.3f} (min {STAGE2_ACC})")
    if not acc >= STAGE2_ACC:
        fail(f"stage 2, {label}: held-out accuracy below {STAGE2_ACC}")
    return clf


def host_cv_accuracies(hvs, k3):
    """Accuracies of ``hvs.run(clf)`` (the host-CV branch) with
    VoxelSelector's K3 replaced by ``k3(blk, data, eps)``."""
    from brainiak_tpu_torch.fcma import voxelselector as vsm

    saved = vsm.fcma_corr_normalize
    vsm.fcma_corr_normalize = \
        lambda blk, data, eps, precision=None: k3(blk, data, eps)
    try:
        return check_accuracies(hvs.run(_KernelNearestMean()),
                                hvs.num_voxels)
    finally:
        vsm.fcma_corr_normalize = saved


def run_long_subjects(torch, rows):
    """The entry points on 2 subjects x 40 epochs (each subject spans
    two epoch tiles): run('svm') through K1's multi-tile tensor-core
    kernel, the host-CV branch through K3's long-subject tensor-core
    kernel and a portioned Classifier fit through K4's multi-tile
    tensor-core kernel, each held against its plain path; and K1's and
    K3's accuracies with the FMA kernel forced on the same voxels."""
    from brainiak_tpu_torch.fcma import Classifier
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector
    from brainiak_tpu_torch.ops import fcma_kernels as fk
    from brainiak_tpu_torch.ops.kernels import epoch_norm as en

    rng = np.random.default_rng(SEED + 2)
    n_e, eps, n_v = 80, 40, 2048
    # the epochs normalized by the ingest entry point (K2 on the card)
    en.reset_launches()
    x = en.normalize_epochs(list(rng.standard_normal(
        (n_e, 150, n_v + 512), dtype=np.float32)))
    k2 = k2_launches("long subjects")
    raw1 = [e[:, :n_v] for e in x]
    raw2 = [e[:, n_v:] for e in x]
    labels = np.array([0, 1] * (n_e // 2))
    pairs = list(zip(raw1, raw2))
    fk.reset_launches()
    t0 = time.perf_counter()
    vs = VoxelSelector(labels, eps, 4, raw1)
    results = vs.run('svm')
    hvs = VoxelSelector(labels, eps, 4, [m[:, :128] for m in raw1],
                        raw_data2=raw1, voxel_unit=128)
    host = hvs.run(_KernelNearestMean())
    clf = Classifier(_KernelNearestMean(), num_processed_voxels=128,
                     epochs_per_subj=eps, device="cuda")
    clf.fit(pairs, labels, num_training_samples=n_e // 2)
    pred = clf.predict()
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    launches = fk.launches()
    log(f"long subjects (E={n_e}, {eps} epochs per subject, V={n_v}): "
        f"run('svm'), host-CV on 128 voxels and a portioned fit in "
        f"{t_all:.2f} s; launches {launches}; K2 before them {k2}")
    for name, row in (("fcma_gram_tcm", "fcma_gram_e80"),
                      ("fcma_corr_normalize_tcl", "fcma_corr_normalize_e80"),
                      ("fcma_sample_gram_tcm", "fcma_sample_gram_n80")):
        if launches[name] < 1:
            fail(f"long subjects: {name} was not launched")
        rows[row]["launches"] = launches[name]
    if launches["fcma_gram"] != launches["fcma_gram_tcm"]:
        fail("long subjects: K1 took a kernel other than the multi-tile "
             "tensor-core one")
    if launches["fcma_corr_normalize"] != \
            launches["fcma_corr_normalize_tcl"]:
        fail("long subjects: K3 took a kernel other than the long-subject "
             "tensor-core one")
    if launches["fcma_sample_gram"] != launches["fcma_sample_gram_tcm"]:
        fail("long subjects: K4 took a kernel other than the multi-tile "
             "tensor-core one")
    accs = check_accuracies(results, n_v)
    host = check_accuracies(host, 128)
    if pred.shape != (n_e // 2,):
        fail("long subjects: the classifier predicted the wrong shape")
    # both K1 routes against plain on the same voxels, so that a change
    # to K1's arithmetic shows beside the FMA kernel's; the path's gates
    compare_with_plain(torch, vs, accs, 256, label="K1 [tcm] (the path's)")
    compare_with_plain(torch, vs,
                       forced_route_accuracies(torch, vs, 256, "ffma"),
                       256, label="K1 [ffma] (forced)", gate=False)
    # the host-CV branch's accuracies (every block voxel paired with
    # itself) against the plain K3's, and the FMA K3's beside them
    plain = host_cv_accuracies(hvs, fk.fcma_corr_normalize_plain)
    ffma = host_cv_accuracies(hvs, lambda blk, data, eps: (
        fk._kernel_corr_normalize(blk, data, eps, route="ffma")))
    for label, got, gate in (("K3 [tcl] (the path's)", host, True),
                             ("K3 [ffma] (forced)", ffma, False)):
        same = float(np.mean(got == plain))
        log(f"  host-CV {label} vs plain K3 accuracies on 128 voxels: "
            f"equal on {same:.4f}, max diff "
            f"{np.max(np.abs(got - plain)):.4f}")
        if gate and same < ACC_AGREE:
            fail(f"long subjects: host-CV {label} accuracies disagree "
                 "with the plain K3's")
    compare_classifier_with_plain(torch, clf, pairs, labels, n_e // 2)


def run_study(torch, rows):
    """The FCMA face-scene study's design, whole brain: 18 subjects x 12
    epochs of 12 TRs (2 conditions x 6) on the 64x64x16 volume (65,536
    voxels), mask1 = 1024 voxels (16 of them coupled to 2048 others in
    condition 1), mask2 = the whole volume, one subject a fold;
    ``prepare_fcma_data``, then ``VoxelSelector(...).run('svm')``, which
    must launch K1 through route "tcs" alone (a slab at a time,
    fcma_corr_tcl.cu's raw mode then fcma_gram_tcs.cu).  The warm
    seconds, the device time of a profiled run by kernel, the peak
    device memory, and the kernel path's accuracies against plain on
    256 voxels (gated), with those of fcma_corr.cu's K1 forced on the
    same voxels beside them.  ``{kernel: launches}`` of the cold run."""
    from brainiak_tpu_torch.fcma import prepare_fcma_data
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector
    from brainiak_tpu_torch.ops import fcma_kernels as fk
    from brainiak_tpu_torch.ops.kernels import epoch_norm as en

    rng = np.random.default_rng(SEED + 3)
    shape = (64, 64, 16)
    n_vox = int(np.prod(shape))
    order = rng.permutation(n_vox)
    sel, planted_v = np.sort(order[:1024]), order[1024:3072]
    images, conditions = synthetic_images(rng, 18, shape, 144, sel[:16],
                                          planted_v, epoch_len=12)
    mask1 = np.zeros(shape, dtype=bool)
    mask1.flat[sel] = True
    label = "study of 216 epochs"
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    en.reset_launches()
    t0 = time.perf_counter()
    raw1, raw2, labels = prepare_fcma_data(images, conditions, mask1,
                                           np.ones(shape, dtype=bool))
    t_prep = time.perf_counter() - t0
    vs = VoxelSelector(labels, 12, 18, raw1, raw_data2=raw2,
                       svm_iters=STUDY_SVM_ITERS)
    results = vs.run('svm')
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = dict(fk.launches(), **k2_launches(label))
    del images
    rows["epoch_zscore_e216"]["launches"] = launches["epoch_zscore_tile"]
    if launches["fcma_gram_tcs"] < 1 or \
            launches["fcma_gram"] != launches["fcma_gram_tcs"] or \
            launches["fcma_gram_tcs_tcl"] < 1 or \
            launches["fcma_gram_tcs_tc"] != 0 or \
            launches["fcma_gram_tcs_gram"] != launches["fcma_gram_tcs_tcl"]:
        fail(f"{label}: run('svm') did not run K1 through the slab "
             f"route alone (raw correlation, then its Gram): {launches}")
    rows["fcma_gram_e216"]["launches"] = launches["fcma_gram_tcs"]
    accs = check_accuracies(results, vs.num_voxels)
    t0 = time.perf_counter()
    vs.run('svm')
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    top = set(np.argsort(-accs, kind="stable")[:16].tolist())
    log(f"{label}: E={len(labels)} (12 a subject, T=12) V1="
        f"{vs.num_voxels} V2={vs.num_voxels2} folds 18, svm_iters "
        f"{STUDY_SVM_ITERS}; prepare {t_prep:.2f} s, cold path "
        f"{t_cold:.2f} s, warm run('svm') {t_warm:.3f} s = "
        f"{vs.num_voxels / t_warm:.1f} voxels/s; max KKT gap "
        f"{float(np.max(vs.kkt_gaps_)):.3e}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; planted "
        f"voxels in the top 16: {len(top & set(range(16)))}/16; launches "
        f"{launches}")
    # a run here is half a million launches: raw profiler events
    profile_run(torch, vs, label, t_warm, k1_kernels=(
        "fcma_corr_tcl_kernel", "fcma_gram_tcs_kernel", "gram_sum_kernel"),
                raw=True)
    compare_with_plain(torch, vs, accs, 256, label="K1 [tcs] (the path's)")
    compare_with_plain(torch, vs,
                       forced_route_accuracies(torch, vs, 256, "ffma"),
                       256, label="K1 [ffma] (forced)", gate=False)
    del vs
    torch.cuda.empty_cache()
    run_study_stage2(torch, rows, raw1, raw2, np.asarray(labels))


def run_study_stage2(torch, rows, raw1, raw2, labels):
    """Stage 2 of the study: a portioned Classifier fit on all 216
    samples (mask1 x the whole volume, 128 voxels a portion, groups of
    12), the last subject held out as leave-one-subject-out FCMA does.
    Every K4 launch must take the slab route "tcs" (a slab at a time,
    fcma_corr_tcl.cu's raw mode, fcma_gram_tcs.cu, then
    fcma_sample_gram_tcs.cu's block-voxel sum); the fit is held against
    the plain fit and its held-out accuracy gated at STAGE2_ACC."""
    from brainiak_tpu_torch.ops import fcma_kernels as fk

    pairs = list(zip(raw1, raw2))
    n_train = len(labels) - 12
    fk.reset_launches()
    clf = run_stage2(torch, "study of 216 epochs, portioned (K4)",
                     dict(num_processed_voxels=128, epochs_per_subj=12),
                     pairs, labels, None, labels[n_train:],
                     dict(num_training_samples=n_train))
    k4 = fk.launches()
    calls = k4["fcma_sample_gram_tcs"]
    n_slabs = fk.tcs_slabs(raw1[0].shape[1], len(labels),
                           raw2[0].shape[1])[1]
    log(f"  K4 launches {k4['fcma_sample_gram']}, {calls} of them the slab "
        f"route ({n_slabs} slabs a call): correlation "
        f"{k4['fcma_sample_gram_tcs_tcl']} (raw mode) + "
        f"{k4['fcma_sample_gram_tcs_r']} (r mode), Gram "
        f"{k4['fcma_sample_gram_tcs_gram']}, block-voxel sum "
        f"{k4['fcma_sample_gram_tcs_sum']}")
    per_call = calls * n_slabs
    if calls < 1 or k4["fcma_sample_gram"] != calls or n_slabs != 8 or \
            k4["fcma_sample_gram_tcs_r"] != 0 or \
            any(k4[f"fcma_sample_gram_tcs_{key}"] != per_call
                for key in ("tcl", "gram", "sum")):
        fail("study stage 2: K4 did not run through the slab route alone, "
             f"8 slabs a call: {k4}")
    rows["fcma_sample_gram_n216"]["launches"] = calls
    compare_classifier_with_plain(torch, clf, pairs, labels, n_train)
    del clf, pairs
    torch.cuda.empty_cache()


def zscored_cols(torch, rng, n_t, n_v, dev):
    """[T, V] float32 columns z-scored with 1/sqrt(T) (a product of
    two columns is their Pearson r), made from a numpy seed."""
    x = torch.from_numpy(rng.standard_normal((n_t, n_v),
                                             dtype=np.float32)).to(dev)
    x -= x.mean(dim=0, keepdim=True)
    x /= x.std(dim=0, keepdim=True, correction=0) * n_t ** 0.5
    return x.contiguous()


def slab_max_err(torch, got, z, z_b, rows=4096):
    """Largest |got - z.T @ z_b| (NaN-aware, positions must agree),
    the product formed in row slabs so that no second full [V, V]
    exists."""
    worst = 0.0
    for r in range(0, got.shape[0], rows):
        want = torch.matmul(z[:, r:r + rows].T, z_b)
        part = got[r:r + rows]
        if not torch.equal(torch.isnan(part), torch.isnan(want)):
            fail("NaN positions differ from the plain product")
        diff = (part - want).abs().nan_to_num(0.0)
        worst = max(worst, diff.max().item())
        del want, diff
    return worst


def clock_power(torch, fn, reps):
    """SM clock and board power that ``nvidia-smi`` samples every 50 ms
    while fn() runs ``reps`` times back to back, the first quarter of
    the samples (the lead-in) dropped: a line of text."""
    fn()
    torch.cuda.synchronize()
    mon = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        mon.terminate()
        try:
            text = mon.communicate(timeout=10)[0]
        except subprocess.TimeoutExpired:
            mon.kill()
            text = mon.communicate()[0]
    samples = [tuple(float(v) for v in line.split(","))
               for line in text.splitlines() if line.count(",") == 1]
    busy = samples[len(samples) // 4:]
    if not busy:
        return "no nvidia-smi samples"
    clocks = sorted(c for c, _ in busy)
    power = sorted(w for _, w in busy)
    return (f"SM clock MHz min/median/max {clocks[0]:.0f}/"
            f"{clocks[len(clocks) // 2]:.0f}/{clocks[-1]:.0f}, power W "
            f"median {power[len(power) // 2]:.1f} max {power[-1]:.1f} "
            f"({len(busy)} samples)")


def check_k5(torch, rng, n_t, n_local, n_block, n_shards, owner, dev,
             reps, same=False, nan_col=None, routes=("tc",), clocks=False):
    """K5 against mma_update on z-scored inputs, on each of ``routes``
    (``"tc"``: ring_mma_tc.cu, the route of every call, timed on
    operands split once as the ring splits them; ``"ffma"``:
    ring_mma.cu, forced) on the same inputs; the other column blocks
    held bit-identical to a sentinel.  ``same``: the panel is the
    resident block itself (one shard of a Gram), so the function is
    symmetric and its bound counts n (n + 1) / 2 entries.  ``clocks``:
    the card's SM clock and power while the tensor-core kernel and
    cuBLAS run.  ``{route: row of its figures}`` (reps > 0) or None."""
    from brainiak_tpu_torch.ops.kernels import ring as kr

    z = zscored_cols(torch, rng, n_t, n_local, dev)
    rot = z if same else zscored_cols(torch, rng, n_t, n_block, dev)
    if nan_col is not None:
        z[:, nan_col] = float("nan")
        rot[:, nan_col % n_block] = float("nan")
    width = n_shards * n_block
    blk = slice(owner * n_block, (owner + 1) * n_block)
    rows = {}
    got = None
    for route in routes:
        if got is None:
            got = torch.full((n_local, width), -7.0, device=dev)
        else:
            got[:, blk] = -7.0
        kr._kernel_ring_mma(got, z, rot, owner, n_shards=n_shards,
                            route=route)
        torch.cuda.synchronize()
        for k in range(n_shards):
            if k != owner and not bool(
                    (got[:, k * n_block:(k + 1) * n_block] == -7.0).all()):
                fail(f"K5 ({route}) wrote outside its block (block {k})")
        err = slab_max_err(torch, got[:, blk], z, rot)
        label = (f"K5 ring_mma ({route}) T={n_t} n_local={n_local} "
                 f"B={n_block} n={n_shards} owner={owner}"
                 f"{' panel = resident block' if same else ''}")
        if nan_col is not None:
            n_nan = int(torch.isnan(got).sum())
            label += f" NaN entries {n_nan} (want {n_local + n_block - 1})"
            if n_nan != n_local + n_block - 1:
                fail("K5 NaN entries are not one row and one column")
        log(f"{label}: max_abs_err {err:.3e} (atol {K5_ATOL}); other "
            "blocks bit-identical to the sentinel")
        if not err <= K5_ATOL:
            fail(f"K5 ({route}) disagrees with its plain version")
        if not reps:
            continue
        # each input read once, the block written once; a symmetric
        # block's products counted once a pair
        n_bytes = 4 * (n_t * n_local + (0 if same else n_t * n_block)
                       + n_local * n_block)
        n_flops = n_t * n_local * (n_local + 1) if same else \
            2 * n_t * n_local * n_block
        b_ms, b_by = bound_ms(n_bytes, 0, 3 * n_flops) if route == "tc" \
            else bound_ms(n_bytes, n_flops)
        if route == "tc":
            a = kr.split(z)
            b = a if same else kr.split(rot)
        else:
            a, b = z, rot

        def step():
            kr._kernel_ring_mma(got, a, b, owner, n_shards=n_shards,
                                route=route)

        def library():
            torch.matmul(z.T, rot)

        row = {"max_abs_err": err, "ms": cuda_ms(torch, step, reps),
               "plain_ms": cuda_ms(torch, lambda: kr.mma_update(
                   got, z, rot, owner * n_block), 1),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": cuda_ms(torch, library, reps)}
        log(f"  ms {row['ms']:.3f} plain_ms {row['plain_ms']:.3f} bound_ms "
            f"{b_ms:.3f} ({b_by}) library_ms {row['library_ms']:.3f}")
        if clocks and route == "tc":
            for what, fn, ms in (("tensor-core K5", step, row["ms"]),
                                 ("cuBLAS", library, row["library_ms"])):
                log(f"  {what}, back to back: "
                    f"{clock_power(torch, fn, max(5, int(1500 / ms)))}")
        rows[route] = row
        del a, b
    return rows if reps else None


def check_k5_raw(torch, rng, dev, n_t=600, n_v=512):
    """K5's tensor-core kernel on unnormalized inputs (scales 1e3 and
    1e-3) against the float64 product: within four times the error of
    the fp32 product (TF32 off)."""
    from brainiak_tpu_torch.ops.kernels import ring as kr

    for scale in (1e3, 1e-3):
        z, rot = (torch.from_numpy((rng.standard_normal((n_t, n_v)) * scale)
                                   .astype(np.float32)).to(dev)
                  for _ in range(2))
        got = kr.ring_mma(torch.empty((n_v, n_v), device=dev), z, rot, 0,
                          n_shards=1)
        exact = z.double().T @ rot.double()
        err = (got.double() - exact).abs().max().item()
        err_plain = (torch.matmul(z.T, rot).double() - exact).abs().max() \
            .item()
        log(f"K5 (tc) raw inputs x {scale:g}, T={n_t}, {n_v} x {n_v}: max "
            f"err vs float64 {err:.4g}, fp32 product's {err_plain:.4g} "
            f"(rule: within 4x)")
        if not err <= 4 * err_plain:
            fail("K5's tensor-core kernel loses accuracy on raw inputs")


def check_split(torch, rng, dev, reps):
    """The tensor-core route's pre-pass kernel against split_kmajor, bit
    for bit: path A's operand [600, 65536] with a NaN column (timed, a
    row of its figures), and a ragged strided one (T=7, every other
    column of 260)."""
    from brainiak_tpu_torch.ops.kernels import ring as kr

    x = zscored_cols(torch, rng, 600, 65536, dev)
    x[:, 9] = float("nan")
    ragged = zscored_cols(torch, rng, 7, 260, dev)[:, ::2]
    for op in (x, ragged):
        t_pad = kr.t_padded(op.shape[0])
        got = kr.split(op)
        want = kr.split_kmajor(op, t_pad)
        torch.cuda.synchronize()
        same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got[:2], want))
        log(f"K5 pre-pass split [{op.shape[0]}, {op.shape[1]}] "
            f"strides {op.stride()} -> 2 x [{op.shape[1]}, {t_pad}]: "
            f"bit-identical to split_kmajor: {same}")
        if not same:
            fail("K5's pre-pass disagrees with split_kmajor")
        del got, want
    n_t, n = x.shape
    b_ms, b_by = bound_ms(4 * n_t * n + 8 * n * kr.t_padded(n_t), 0)
    row = {"max_abs_err": 0.0, "ms": cuda_ms(torch, lambda: kr.split(x), reps),
           "plain_ms": cuda_ms(torch, lambda: kr.split_kmajor(
               x, kr.t_padded(n_t)), 1),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    log(f"  ms {row['ms']:.3f} plain_ms {row['plain_ms']:.3f} bound_ms "
        f"{b_ms:.3f} ({b_by})")
    return row


#: K5's kernels by name in a profile: the tensor-core route's product
#: and pre-pass (ring_mma_tc_kernel, split_kmajor_kernel), the FMA one
K5_KERNELS = ("ring_mma", "split_kmajor")


#: K5's shapes: (T, n_local, B, n_shards, owner, timed reps, panel =
#: resident block, routes) of path A's one-card ring (a Gram: both
#: kernels on the same inputs, and the card's clock and power), one
#: step of path B's 4-position ring, path C's step (the ISFC's panel
#: is the other subjects' mean)
RING_SHAPES = {
    "ring_mma": (600, 65536, 65536, 1, 0, 3, True, ("tc", "ffma")),
    "ring_mma_n4": (600, 16384, 16384, 4, 2, 5, False, ("tc",)),
    "ring_mma_v8192": (600, 8192, 8192, 1, 0, 10, False, ("tc",))}


def phase_ring_kernel(torch, dev, shapes=RING_SHAPES):
    """K5 at the ring paths' shapes, then at a ragged shape with a NaN
    column on both kernels (checked, not timed), the tensor-core kernel
    on raw inputs against float64, then the pre-pass against its plain
    version.  Rows are named as the shapes, the forced FMA kernel's
    with ``_ffma``; the pre-pass's row is ``ring_split``."""
    rng = np.random.default_rng(SEED + 3)
    rows = {}
    for name, (n_t, n_local, n_block, n, owner, reps, same, routes) in \
            shapes.items():
        got = check_k5(torch, rng, n_t, n_local, n_block, n, owner, dev,
                       reps, same=same, routes=routes,
                       clocks=name == "ring_mma")
        for route, row in got.items():
            rows[name if route == "tc" else f"{name}_{route}"] = row
        torch.cuda.empty_cache()
    check_k5(torch, rng, 7, 130, 67, 3, 1, dev, 0, nan_col=5,
             routes=("tc", "ffma"))
    check_k5_raw(torch, rng, dev)
    rows["ring_split"] = check_split(torch, rng, dev, 5)
    torch.cuda.empty_cache()
    return rows


def profile_once(torch, fn, kernels):
    """One call of fn under torch.profiler: the device busy
    milliseconds, and those of the kernels whose name holds one of
    ``kernels``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = mine = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy += ev.self_device_time_total / 1e3
        if any(k in ev.key for k in kernels):
            mine += ev.self_device_time_total / 1e3
    return busy, mine


def run_ring_paths(torch, rows, n_t=600, n_v=65536):
    """Ring paths A and B on one whole-brain subject (T=600, V=65,536,
    the 64x64x16 volume)."""
    from brainiak_tpu_torch.ops import distla
    from brainiak_tpu_torch.ops.kernels import ring as kr
    from brainiak_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(SEED + 4)
    data = rng.standard_normal((n_t, n_v), dtype=np.float32)
    data[:, 7] = 1.5    # a constant voxel: its row and column are 0
    mesh1 = make_mesh(("voxel",), (-1,))
    log(f"ring path A: gram of [{n_t}, {n_v}] on {mesh1}, budget "
        f"{distla.replicated_budget_bytes()} bytes, replicated working "
        f"set {4 * (n_t * n_v + n_v * n_v)} bytes")

    torch.cuda.reset_peak_memory_stats()
    kr.reset_launches()
    t0 = time.perf_counter()
    out = distla.gram(data, mesh=mesh1)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = kr.launches()
    rows["ring_mma"]["launches"] = kr.launches("tc")
    rows["ring_split"]["launches"] = kr.launches("split")
    if launches < 1:
        fail("ring path A did not run K5")
    if kr.launches("tc") != launches or kr.launches("split") != launches:
        fail(f"ring path A: {kr.launches('tc')} of {launches} K5 launches "
             f"on the tensor-core kernel, {kr.launches('split')} pre-pass "
             "splits (want one each, the panel being the resident block)")
    del out
    t0 = time.perf_counter()
    out_a = distla.gram(data, mesh=mesh1)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    z = distla._zscore_cols(torch.from_numpy(data).cuda())
    err = slab_max_err(torch, out_a, z, z)
    if not bool((out_a[7] == 0).all() and (out_a[:, 7] == 0).all()):
        fail("ring path A: the constant voxel's row or column is not 0")
    split_bytes = 8 * n_v * kr.t_padded(n_t)
    log(f"  path A: K5 launches {launches}, all on the tensor-core kernel, "
        f"cold {t_cold:.3f} s, warm {t_warm:.3f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB (of which the pre-pass's hi and lo "
        f"buffers {split_bytes / 2**30:.2f} GiB), max err vs plain "
        f"{err:.3e} (atol {K5_ATOL})")
    if not err <= K5_ATOL:
        fail("ring path A disagrees with the plain product")
    del z
    busy, k5 = profile_once(
        torch, lambda: distla.gram(data, mesh=mesh1), K5_KERNELS)
    log(f"  path A profiled: device busy {busy:.3f} ms, K5 {k5:.3f} ms "
        f"({k5 / (1e3 * t_warm):.3f} of the unprofiled warm run)")

    mesh4 = make_mesh(("voxel",), (4,), devices=["cuda"] * 4)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kr.reset_launches()
    out_b = distla.gram(data, mesh=mesh4)
    torch.cuda.synchronize()
    launches = kr.launches()
    rows["ring_mma_n4"]["launches"] = kr.launches("tc")
    if launches != 16 or kr.launches("tc") != 16 or \
            kr.launches("split") != 4:
        fail(f"ring path B ran {launches} K5 launches, "
             f"{kr.launches('tc')} on the tensor-core kernel, not 16, "
             f"and {kr.launches('split')} pre-pass splits, not 4")
    del out_b
    t0 = time.perf_counter()
    out_b = distla.gram(data, mesh=mesh4)
    torch.cuda.synchronize()
    t_warm_b = time.perf_counter() - t0
    peak_b = torch.cuda.max_memory_allocated() - held
    worst, n_diff = 0.0, 0
    for r in range(0, n_v, 4096):
        diff = (out_b[r:r + 4096] - out_a[r:r + 4096]).abs()
        worst = max(worst, diff.max().item())
        n_diff += int((diff != 0).sum())
    log(f"  path B: 4 positions on one card, K5 launches {launches}, warm "
        f"{t_warm_b:.3f} s, peak device memory beyond A's output "
        f"{peak_b / 2**30:.2f} GiB; vs path A max diff {worst:.3e} "
        f"(atol {RING_AB_ATOL}), entries not bit-identical {n_diff}")
    if not worst <= RING_AB_ATOL:
        fail("ring path B disagrees with path A")
    del out_a, out_b
    torch.cuda.empty_cache()


def run_isfc_path(torch, rows, n_s=8, n_t=600, n_v=8192):
    """Ring path C: leave-one-out ISFC of 8 subjects x 600 TRs on the
    one-mask volume (32x32x8, 8,192 voxels) on the one-card mesh,
    against the dense path, then isc."""
    from brainiak_tpu_torch import isc as tisc
    from brainiak_tpu_torch.ops.kernels import ring as kr
    from brainiak_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(SEED + 5)
    signal = rng.standard_normal((n_t, n_v), dtype=np.float32)
    data = np.stack([signal + rng.standard_normal((n_t, n_v),
                                                  dtype=np.float32)
                     for _ in range(n_s)], axis=2)
    mesh1 = make_mesh(("voxel",), (-1,))
    tisc.isfc(data, mesh=mesh1)
    kr.reset_launches()
    t0 = time.perf_counter()
    ring = tisc.isfc(data, mesh=mesh1)
    t_warm = time.perf_counter() - t0
    launches = kr.launches()
    rows["ring_mma_v8192"]["launches"] = kr.launches("tc")
    if launches != n_s or kr.launches("tc") != n_s or \
            kr.launches("split") != 2 * n_s:
        fail(f"ring path C ran {launches} K5 launches, "
             f"{kr.launches('tc')} on the tensor-core kernel, not {n_s}, "
             f"and {kr.launches('split')} pre-pass splits, not {2 * n_s}")
    t0 = time.perf_counter()
    tisc._isfc_ring(data, data, mesh1, True, True)
    t_dev = time.perf_counter() - t0
    busy, k5 = profile_once(
        torch, lambda: tisc._isfc_ring(data, data, mesh1, True, True),
        K5_KERNELS)
    t0 = time.perf_counter()
    dense = tisc.isfc(data)
    t_dense = time.perf_counter() - t0
    errs = [float(np.max(np.abs(r - d))) for r, d in zip(ring, dense)]
    shapes = [r.shape for r in ring]
    log(f"ring path C: isfc of {n_s} subjects x {n_t} TRs x {n_v} "
        f"voxels, K5 launches {launches}; warm {t_warm:.3f} s, of which "
        f"the {n_s} rings and their copies to the host {t_dev:.3f} s "
        f"(profiled: device busy {busy:.3f} ms, K5 {k5:.3f} ms) and "
        f"the host's float64 assembly and squareform the rest "
        f"{t_warm - t_dev:.3f} s; dense isfc {t_dense:.3f} s; shapes "
        f"{shapes}; max diff vs dense {max(errs):.3e} (atol {ISFC_ATOL})")
    if shapes != [(n_s, n_v * (n_v - 1) // 2), (n_s, n_v)] or \
            not all(np.all(np.isfinite(r)) for r in ring):
        fail("ring path C: isfc returned the wrong shapes or non-finite "
             "values")
    if not max(errs) <= ISFC_ATOL:
        fail("ring path C disagrees with the dense isfc")
    ring_iscs = ring[1]
    del ring, dense
    t0 = time.perf_counter()
    loo = tisc.isc(data)
    pair = tisc.isc(data, pairwise=True)
    t_isc = time.perf_counter() - t0
    log(f"  isc leave-one-out {loo.shape} mean {loo.mean():.3f}, pairwise "
        f"{pair.shape} mean {pair.mean():.3f}, both in {t_isc:.3f} s; "
        f"the ring ISFC's diagonal vs isc max diff "
        f"{float(np.max(np.abs(ring_iscs - loo))):.3e}")
    if loo.shape != (n_s, n_v) or pair.shape != (n_s * (n_s - 1) // 2,
                                                 n_v) \
            or not (np.all(np.abs(loo) <= 1) and np.all(np.abs(pair) <= 1)):
        fail("isc returned the wrong shapes or values outside [-1, 1]")
    if not (loo.mean() > 0.3 and pair.mean() > 0.3):
        fail("isc does not find the planted shared signal")


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
    if launches["fcma_gram_tc"] != 1:
        fail(f"whole brain: run('svm') launched the tensor-core K1 "
             f"{launches['fcma_gram_tc']} times, not once")
    rows["fcma_gram"]["launches"] = launches["fcma_gram_tc"]
    rows["epoch_zscore"]["launches"] = launches["epoch_zscore_tile"]
    # fcma_corr.cu's K1 over the FCMA paths (whole brain, one mask,
    # long subjects; the last takes fcma_gram_tcm.cu alone, or
    # run_long_subjects fails)
    ffma_launches = launches["fcma_gram"] - launches["fcma_gram_tc"] - \
        launches["fcma_gram_tcm"] - launches["fcma_gram_tcs"]

    # host-CV branch on the same data: K3 per block of 128 voxels, then
    # per block of the default voxel_unit (256); every launch must take
    # the tensor-core kernel, and the accuracies must not depend on the
    # block beyond what the Gram's batch may round
    raw1 = [m[:, :256] for m in vs.raw_data]
    host = {}
    for unit, row in ((128, "fcma_corr_normalize"),
                      (256, "fcma_corr_normalize_b256")):
        hvs = VoxelSelector(vs.labels, 4, 4, raw1, raw_data2=vs.raw_data2,
                            voxel_unit=unit)
        hvs._stack()
        fk.reset_launches()
        t0 = time.perf_counter()
        host[unit] = hvs.run(_KernelNearestMean())
        t_host = time.perf_counter() - t0
        k3 = fk.launches()
        rows[row]["launches"] = k3["fcma_corr_normalize_tc"]
        log(f"host-CV branch, voxel_unit={unit}: 256 voxels in "
            f"{t_host:.2f} s, K3 launches {k3['fcma_corr_normalize']}, "
            f"{k3['fcma_corr_normalize_tc']} of them tensor-core")
        if k3["fcma_corr_normalize"] < 1 or \
                k3["fcma_corr_normalize_tc"] != k3["fcma_corr_normalize"]:
            fail("the host-CV branch did not run K3 on the tensor-core "
                 "kernel alone")
        del hvs
    a128, a256 = (check_accuracies(host[u], 256) for u in (128, 256))
    same = float(np.mean(a128 == a256))
    log(f"  host-CV accuracies at voxel_unit 128 and 256 equal on {same:.4f}"
        f" of 256 voxels, max diff {np.max(np.abs(a128 - a256)):.4f}")
    if same < ACC_AGREE or \
            np.max(np.abs(a128 - a256)) > 4 / len(vs.labels) + 1e-6:
        fail("the host-CV accuracies depend on voxel_unit")
    del images
    torch.cuda.empty_cache()

    # stage 2 on the whole-brain data: (i) portioned, through K4, on
    # mask1 x the whole volume; (ii) single portion, self-correlation
    # of the 512 voxels that stage 1 ranked first.  Train on the first
    # 6 subjects' 24 epochs, test on the last 2 subjects' 8.
    n_train = 24
    labels = vs.labels
    pairs = list(zip(vs.raw_data, vs.raw_data2))
    fk.reset_launches()
    clf = run_stage2(torch, "portioned (K4)",
                     dict(num_processed_voxels=128, epochs_per_subj=4),
                     pairs, labels, None, labels[n_train:],
                     dict(num_training_samples=n_train))
    k4 = fk.launches()
    rows["fcma_sample_gram"]["launches"] = k4["fcma_sample_gram_tc"]
    log(f"  K4 launches {k4['fcma_sample_gram']}, "
        f"{k4['fcma_sample_gram_tc']} of them tensor-core")
    if k4["fcma_sample_gram"] < 1 or \
            k4["fcma_sample_gram_tc"] != k4["fcma_sample_gram"]:
        fail("the portioned classifier did not run K4 on the tensor-core "
             "kernel alone")
    compare_classifier_with_plain(torch, clf, pairs, labels, n_train)
    del clf, pairs
    torch.cuda.empty_cache()
    ranked = np.argsort(-accs, kind="stable")[:512]
    raw = [m[:, ranked] for m in vs.raw_data]
    run_stage2(torch, "single portion, self-correlation of 512 voxels",
               dict(epochs_per_subj=4),
               [(m, m) for m in raw[:n_train]], labels[:n_train],
               [(m, m) for m in raw[n_train:]], labels[n_train:])
    del vs, raw
    torch.cuda.empty_cache()

    # main path, one mask (V=8192, E=16)
    shape = (32, 32, 8)
    n_vox = int(np.prod(shape))
    order = rng.permutation(n_vox)
    images, conditions = synthetic_images(rng, 4, shape, 600, order[:16],
                                          order[16:1040])
    _, _, launches = run_path(torch, "one mask", images, conditions,
                              np.ones(shape, dtype=bool), None, 4, 256)
    if launches["fcma_gram_tc"] != 1:
        fail(f"one mask: run('svm') launched the tensor-core K1 "
             f"{launches['fcma_gram_tc']} times, not once")
    rows["fcma_gram_e16"]["launches"] = launches["fcma_gram_tc"]
    ffma_launches += launches["fcma_gram"] - launches["fcma_gram_tc"] - \
        launches["fcma_gram_tcm"] - launches["fcma_gram_tcs"]
    torch.cuda.empty_cache()

    run_long_subjects(torch, rows)
    torch.cuda.empty_cache()
    # the study path takes K1's slab route alone, or run_study fails
    run_study(torch, rows)
    torch.cuda.empty_cache()
    for name in ("fcma_gram_ffma", "fcma_gram_ffma_e16",
                 "fcma_gram_e80_ffma", "fcma_gram_e216_ffma",
                 "fcma_gram_e128_ffma"):
        rows[name]["launches"] = ffma_launches
    # no path takes epoch_norm.cu's K2 (k2_launches fails if one does),
    # fcma_sample_gram.cu's K4 (the stage-2 fits fail if one does) or
    # fcma_corr.cu's K3 (the host-CV checks fail if one does), runs raw
    # features, four sample tiles, K4's slab route at
    # N=128 or K3 at E=96
    for name in ("epoch_zscore_simple", "epoch_zscore_e216_simple",
                 "fcma_corr_normalize_ffma", "fcma_corr_normalize_e80_ffma",
                 "fcma_corr_normalize_e96", "fcma_gram_e128",
                 "fcma_sample_gram_ffma",
                 "fcma_sample_gram_raw", "fcma_sample_gram_raw_ffma",
                 "fcma_sample_gram_n96", "fcma_sample_gram_n96_ffma",
                 "fcma_sample_gram_n80_ffma", "fcma_sample_gram_n216_ffma",
                 "fcma_sample_gram_n128", "fcma_sample_gram_n128_ffma",
                 "fcma_sample_gram_n128_raw"):
        rows[name]["launches"] = 0
    torch.cuda.empty_cache()

    # the SUMMA ring: K5 at the paths' shapes, then paths A-C
    rows.update(phase_ring_kernel(torch, dev))
    run_ring_paths(torch, rows)
    run_isfc_path(torch, rows)
    torch.cuda.empty_cache()
    run_ingest_split(torch, dev)

    csrc = "brainiak_tpu_torch/csrc/"
    k1 = ("brainiak_tpu/ops/pallas_kernels.py:223", csrc + "fcma_corr.cu")
    k1_tc = ("brainiak_tpu/ops/pallas_kernels.py:223",
             csrc + "fcma_gram_tc.cu")
    k1_tcm = ("brainiak_tpu/ops/pallas_kernels.py:223",
              csrc + "fcma_gram_tcm.cu")
    k1_tcs = ("brainiak_tpu/ops/pallas_kernels.py:223",
              csrc + "fcma_gram_tcs.cu")
    k3 = ("brainiak_tpu/ops/pallas_kernels.py:168", csrc + "fcma_corr.cu")
    k3_tc = ("brainiak_tpu/ops/pallas_kernels.py:168",
             csrc + "fcma_corr_tc.cu")
    k3_tcl = ("brainiak_tpu/ops/pallas_kernels.py:168",
              csrc + "fcma_corr_tcl.cu")
    k4 = ("brainiak_tpu/ops/pallas_kernels.py:311",
          csrc + "fcma_sample_gram.cu")
    k4_tc = ("brainiak_tpu/ops/pallas_kernels.py:311",
             csrc + "fcma_sample_gram_tc.cu")
    k4_tcm = ("brainiak_tpu/ops/pallas_kernels.py:311",
              csrc + "fcma_sample_gram_tcm.cu")
    k4_tcs = ("brainiak_tpu/ops/pallas_kernels.py:311",
              csrc + "fcma_sample_gram_tcs.cu")
    k2 = ("brainiak_tpu/ops/kernels/epoch_norm.py:118",
          csrc + "epoch_norm.cu")
    k2_tile = ("brainiak_tpu/ops/kernels/epoch_norm.py:118",
               csrc + "epoch_norm_tile.cu")
    origin = {
        "epoch_zscore": k2_tile, "epoch_zscore_e216": k2_tile,
        "epoch_zscore_simple": k2, "epoch_zscore_e216_simple": k2,
        "fcma_gram": k1_tc, "fcma_gram_e16": k1_tc,
        "fcma_gram_ffma": k1, "fcma_gram_ffma_e16": k1,
        "fcma_gram_e80": k1_tcm, "fcma_gram_e80_ffma": k1,
        "fcma_gram_e216": k1_tcs, "fcma_gram_e216_ffma": k1,
        "fcma_gram_e128": k1_tcs, "fcma_gram_e128_ffma": k1,
        "fcma_corr_normalize": k3_tc, "fcma_corr_normalize_b256": k3_tc,
        "fcma_corr_normalize_ffma": k3, "fcma_corr_normalize_e80": k3_tcl,
        "fcma_corr_normalize_e80_ffma": k3,
        "fcma_corr_normalize_e96": k3_tcl,
        "fcma_sample_gram": k4_tc, "fcma_sample_gram_raw": k4_tc,
        "fcma_sample_gram_ffma": k4, "fcma_sample_gram_raw_ffma": k4,
        "fcma_sample_gram_n96": k4_tcm, "fcma_sample_gram_n80": k4_tcm,
        "fcma_sample_gram_n96_ffma": k4, "fcma_sample_gram_n80_ffma": k4,
        "fcma_sample_gram_n216": k4_tcs, "fcma_sample_gram_n128": k4_tcs,
        "fcma_sample_gram_n128_raw": k4_tcs,
        "fcma_sample_gram_n216_ffma": k4, "fcma_sample_gram_n128_ffma": k4,
    }
    k5 = ("brainiak_tpu/ops/kernels/ring.py:116", csrc + "ring_mma.cu")
    k5_tc = ("brainiak_tpu/ops/kernels/ring.py:116",
             csrc + "ring_mma_tc.cu")
    origin.update(ring_mma=k5_tc, ring_mma_n4=k5_tc, ring_mma_v8192=k5_tc,
                  ring_split=k5_tc, ring_mma_ffma=k5)
    # no path forces ring_mma.cu
    rows["ring_mma_ffma"]["launches"] = 0
    kernels = [dict(name=name, route="cuda", source=origin[name][1],
                    replaces=origin[name][0], launches=row["launches"],
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"],
                    library_ms=row["library_ms"],
                    **{k: row[k] for k in ("corr_ms", "gram_ms", "sum_ms",
                                           "copy_ms", "tile_w")
                       if k in row})
               for name, row in rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
