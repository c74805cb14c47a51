#!/usr/bin/env python3
"""Drive the PyTorch port's paths (FCMA voxel selection and
classification, the SUMMA ring Gram, ISC/ISFC, SRM, the FCMA file
front end, RSRM, SS-SRM, FastSRM, FCMA on a mesh, the SRM family and
FCMA on two ranks, the searchlight, MVPA voxel selection, the
resampling statistics, event segmentation, TFA and HTFA, the encoding
tier, the matrix-normal models, the inverted encoding models, the
hyperparameter optimizer and the fMRI simulator) on one CUDA card.

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
        device times from one call (CUDA events);
     K1 at the mesh paths' shapes (inputs of their own seed): B=256
        against V=65536 (a position of phase 20) and B=1024 against
        V=16384 (a data2 shard of phase 21), each beside fcma_corr.cu's
        FMA kernel forced.
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
   the device time by kernel and the device's busy share.  The
   observability check: with a ``MemorySink`` on, ``prepare_fcma_data``
   must emit ``fcma.epoch_norm`` spans and ``run('svm')`` the spans
   ``fcma.voxel_selection``, one ``fcma.block`` and ``fcma.svm_cv``
   inside the first, every record valid under the port's
   ``validate_record``; warm runs with obs disabled and with the sink
   are timed in turns, and one profiled run of each must make the same
   number of kernel launches.  Then the
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
   own (path C's step); at T=4,000, n_local=B=512, owner 1 of 4 (a step
   of phase 31's ring Gram of the ridge's design); and on unnormalized
   inputs (scales 1e3 and
   1e-3) against the float64 product, within four times the fp32
   product's error.  The pre-pass kernel's hi and lo are held
   bit-identical to ``split_kmajor`` (row ``ring_split``).
9. Ring path A: ``distla.gram`` of one whole-brain subject (T=600,
   V=65,536) on the one-card mesh at the default 8 GiB budget, which
   the 17.3 GB working set exceeds, so the ring runs (one K5 launch,
   which must take the tensor-core kernel, and one split of its one
   operand); held against the plain product in row slabs; warm
   seconds, K5's device time in a profiled run, peak device memory
   with the split buffers.  Its cold run, under a ``MemorySink``, must
   emit one ``distla.gram`` span (``kind`` "summa").
10. Ring path B: the same data on a 4-position mesh of the one card
   (16 K5 launches, owners other than 0, all on the tensor-core
   kernel, and 4 splits: each shard once), held against path A.
11. Ring path C: leave-one-out ``isfc(data, mesh=...)`` of 8 subjects
   x 600 TRs x 8,192 voxels (planted shared signal) on the one-card
   mesh (8 K5 launches, all on the tensor-core kernel, 16 splits),
   held against ``isfc(data)`` without a mesh; ``isc`` leave-one-out
   and pairwise on the same data.
12. The resilient-fit contract on the card: ``run_resilient_loop``
   (40 steps, a checkpoint every 5) over ``make_device_carry_chunk``
   of a power iteration ``v <- G v / |G v|`` on v [8192, 16], G the
   [8192, 8192] Gram of a [600, 8192] subject by ``distla.gram(mesh=)``
   (K5), TF32 off.  A preempted run (``faults.inject("preempt",
   at_step=20)``) resumed from its checkpoint, a NaN at step 15 rolled
   back, and an Inf caught by the sanitizer lane
   (``BRAINIAK_TPU_SANITIZE=1``) and rolled back must each end bit for
   bit on the reference run's iterates; a chunk that is NaN every time
   must abort with ``DivergenceError``, a ``divergence_abort`` event
   and a flight dump; ``call_checked`` must trip on an Inf in a CUDA
   tensor; ``hbm_peak_bytes`` after the first chunk must equal the
   growth of ``torch.cuda.max_memory_allocated()`` across it.  The
   reference run's chunk and checkpoint seconds are printed.
13. The SRM fit contract on the card: ``SRM(n_iter=20,
   features=50).fit`` of 8 subjects x 8,192 voxels x 300 TRs, a
   checkpoint every 5 iterations, against the plain fit (within the
   float32 bounds of phase 14; bit for bit in practice), a fit
   preempted at step 10 and resumed, and a NaN at step 5 rolled back,
   both bit for bit on the uninterrupted checkpointed fit; its chunk
   and checkpoint seconds.
14. SRM at the configuration of BASELINE.md:120 (its shape only: 20
   subjects x 40,000 voxels x 300 TRs, K=50, 10 EM iterations,
   float32; ``X_i = W_i S + 0.1 noise`` with planted orthonormal
   W_i): ``SRM(...).fit``, ``DetSRM(...).fit`` and a ragged SRM fit
   (V_i = 40,000 - 500 i), each once, after phase 13's fits.  Each is
   held to a float64 fit of the same chunk functions on the card from
   the same w0 (max|dW| / max|W| <= 1e-3, |dS|_F / |S|_F <= 1e-3,
   d(logprob) / |logprob| <= 1e-5), to orthonormal maps (|W_i^T W_i -
   I| <= 1e-4) and to the planted structure (mean pairwise
   correlation of the shared responses > 0.9; the principal angles
   to the planted W_i printed).  Each fit's seconds split into host
   stack and pad, upload, init, EM (CUDA events) and fetch, and its
   peak device memory; the host syncs of each solve and of an EM
   iteration (``torch.cuda.set_sync_debug_mode("warn")``); one
   profiled run of the EM: top device ops, launches an iteration, busy
   share.
15. The panel Gram: ``distla.panel_gram`` of one [600, 8192] subject
   on a 4-position mesh of the card, a checkpoint every panel,
   preempted after panel 2 and resumed, held against ``distla.gram``
   to K5_ATOL and against an uninterrupted panel Gram bit for bit.
16. The FCMA file front end: phase 3's 8 subjects written as
   uncompressed ``.nii`` with ``io.save_as_nifti_file`` (1.26 GB; gzip
   of random data would take most of a minute), with both masks and
   the epoch specs, read back by ``io.load_images_from_dir``,
   ``load_boolean_mask`` and ``load_labels``, then
   ``prepare_fcma_data`` and ``run('svm')``, whose results must equal
   phase 3's exactly; write and read seconds.
17. RSRM.  First its fit contract on the card: ``RSRM(n_iter=20,
   features=50, gamma=1).fit`` of 8 subjects x 8,192 voxels x 300 TRs
   with a planted sparse term, a checkpoint every 5 iterations; a fit
   preempted at step 10 and resumed, and a NaN at step 5 rolled back,
   both bit for bit on the uninterrupted checkpointed fit; its chunk
   and checkpoint seconds.  Then RSRM at phase 14's shape (20 x 40,000
   x 300, K=50, 10 iterations, gamma 1, float32) on phase 14's kind of
   data plus a planted sparse term (1% of each subject's entries moved
   by +-5): held to a float64 fit of the same chunk functions on the
   card from the same w0 (max|dW| / max|W| and |dR|_F / |R|_F <= 1e-3,
   d(objective) / |objective| <= 1e-5, the supports of ``s_`` equal on
   >= 99.9% of the entries), to orthonormal maps and to the planted
   term (mean |s_| on it over 5 times that elsewhere, a nonzero share
   of ``s_`` below 0.2); seconds split into host stack, upload, init,
   BCD (CUDA events) and fetch, peak memory, syncs an iteration and
   one profiled BCD run.
18. SS-SRM at the layout of the raider data that the reference's
   image-prediction example loads (synthetic here, planted as
   ``examples/funcalign_variants.py`` plants it): 10 subjects x 1,000
   voxels x 2,203 alignment TRs, 56 labelled samples of 7 classes a
   subject and 56 held out, K=50, alpha 0.5, gamma 1, 10 iterations,
   float32: held-out accuracy >= 0.8, |W_i^T W_i - I| <= 1e-4,
   held-out predictions equal on >= 95% to a float64 fit of the port
   on the card from the same initial W; seconds of the W and MLR
   updates an iteration, the syncs and launches of each.
19. FastSRM on phase 14's data in two sessions of 150 TRs, a
   deterministic atlas of 1,000 parcels, K=50, 100 iterations,
   aggregate "mean": the smallest principal cosine to the planted
   shared response > 0.8, orthonormal bases to 1e-4, the bases within
   1e-3 of max|basis| of a float64 fit of the port on the card from
   the same w0; seconds of the host reduction, the reduced DetSRM, the
   bases (products and the wide SVD apart) and the transform; then a
   fit of the first 4 subjects from ``.npy`` paths with ``temp_dir``
   and ``low_ram`` within 1e-4 of the in-memory fit of the same
   subjects, its spills removed by ``clean()``.
20. ``VoxelSelector(mesh=)`` on phase 3's inputs (run right after
   phase 3's host-CV branch), a 4-position voxel mesh of the one card
   (``devices=["cuda"] * 4``): 4 K1 launches (256 block voxels each
   against the 65,536) and one SMO; the Grams its SMO solves against
   the meshless run's (bit for bit expected, else within
   ``MESH_GRAM_RTOL`` of K[0, 0]), the accuracies against phase 3's;
   warm seconds, launches, peak memory.
21. ``use_distla=True`` on the same inputs: data2 (1.26 GB) split into
   4 shards of 16,384 voxels, one block of the 1,024 mask1 voxels, one
   K1 launch a shard and the partial Grams summed; the Gram within
   ``MESH_GRAM_RTOL`` of K[0, 0] of the meshless K1's, accuracies held
   by ``ACC_AGREE``; warm seconds, launches, peak memory.  Then
   ``use_distla='auto'`` at a 1 GiB budget must engage, and a host-CV
   ``run(clf)`` on 256 voxels degrade with the warning (K3 a
   position), held to phase 3's host-CV branch.
22. Two ranks over NCCL, one card each (``parallel.testing
   .run_distributed(..., device="cuda")``): ``VoxelSelector(mesh=)``
   and ring path C's ``isfc(mesh=)`` on both ranks, against phases 20
   and C.  It needs two cards: on one it prints a line saying so.
23. Two ranks on the one card over gloo (``run_distributed(...,
   device="cuda", backend="gloo")``: both ranks on ``cuda:0``, every
   collective staged through the host), after phase 19: SRM, DetSRM
   and RSRM on a ``'subject'`` mesh of the two ranks, on phase 14's
   data (phase 17's for RSRM), 10 subjects a rank, each rank's fits
   bit for bit the other's.  Each kind runs twice from the same w0
   as phases 14 and 17: in float64 through its chunk functions, within
   1e-10 of the one-process float64 fit (max|W|, max|S| or max|R| and
   the objective), and in float32 through the estimator, within 1e-3
   of max|W|, 3e-3 of max|S| or max|R| and 1e-5 of the objective of
   the one-process float32 fit.  Then phase 22's body:
   ``VoxelSelector(mesh=)`` (K1 once a rank, row ``fcma_gram_rank``)
   held to phase 20's accuracies and the ring ``isfc(mesh=)`` (K5 16
   times a rank with split panels crossing the ranks, row
   ``ring_mma_v4096``) held to the dense ``isfc``.  Each rank's fit
   seconds, K1 and K5 launches, and its collective calls with the
   bytes it sent and received.  Then HTFA on a subject mesh of the two
   ranks (8 subjects of phase 30's layout, 2 x 2 iterations), held to
   the one-process fit in phase 30.
24. The searchlight's traced tier at whole-brain width: 8 subjects on
   a 64 x 64 x 36 grid, 150 TRs, float32, an ellipsoid brain mask of
   56,240 voxels (0.71 GB on the card); ``Ball(3)`` (123 voxels),
   55,808 centres, the RSA statistic of
   ``benchmarks/run_baselines.py:142-155`` in torch, at batch sizes
   256 and 1024: warm centres/s, the launches and device time of a
   batch over a profiled warm sweep, one batch by CUDA events, peak
   memory; 2,000 seeded centres within 1e-4 of a float64 NumPy
   evaluation; a 4-position mesh of the card and two ranks over gloo
   within 1e-6 of the meshless volume.
25. ``MVPAVoxelSelector`` on the host tier: a planted region in a
   seeded 16^3 volume of 120 samples (the layout of
   ``examples/searchlight_decoding.py:31-46``), ``Ball(1)``, 4 folds,
   a nearest-class-mean estimator on raw features; serially and with
   a ``Pool`` of 4 forked after CUDA is initialised: equal volumes,
   the top 5 voxels in the planted region.
27. The resampling nulls at whole brain (run, as 28-31, before phase
   26): 20
   subjects x 300 TRs x 65,536 voxels, float32, one shared signal
   scaled a voxel plus noise a subject (the layout of
   ``benchmarks/run_baselines.py:103-110``); ``isc``, then
   ``bootstrap_isc`` (10,000), ``permutation_isc`` (sign flips,
   10,000; two groups of 10, 5,000), ``timeshift_isc`` and
   ``phaseshift_isc`` (1,000 each), each materialized and counted
   (``return_distribution=False``), every run at its default
   ``null_batch_size``: warm
   resamples/s, peak memory, the launches and syncs of a chunk (runs
   of one and two chunks, profiled).  Gates: on 2,000 seeded voxels
   the same descriptors in float64 NumPy (the ISC-input nulls of the
   first 2,000 resamples bit for bit, 'mean' ones within 1e-12; the
   shift nulls, all 1,000, within 1e-5, by the spectrum), p-values
   equal on >= 99% of the voxels and never 2 counts apart; the counted
   p-map bit for bit the materialized one; a bootstrap preempted after
   its first checkpoint (chunk 20 of 40) and resumed, bit for bit.
28. ``EventSegment`` on a planted segmentation
   (``benchmarks/run_baselines.py:85-100``'s recipe): the full tier
   (V=100, T=500, K=40) and a movie (V=1,000, T=1,976, K=50), float32:
   warm fit seconds, annealing steps, launches and syncs a step (fits
   of 3 steps less 1, profiled), boundary accuracy, peak memory; the
   ``ll_`` of steps 2-30 within 1e-4 of a float64 fit of 30 steps on
   the card; ``find_events`` on held-out data;
   a checkpointed full-tier fit preempted at step 25 and resumed, bit
   for bit the unbroken one.
29. ``TFA`` on one subject: 65,536 voxels (64 x 64 x 16 at 3 mm from a
   scanner origin 100-150 mm off zero) x 600 TRs, K=50 planted
   factors, the reference's defaults (5,000 voxels x 500 TRs a
   subsample, 10 iterations, 60 L-BFGS steps), fitted in float32 and in
   float64: ``rbf_factors``, ``rbf_weight_products``,
   ``rbf_residual_sum`` and the NLLS objective's value and gradient in
   float32 within 1e-5 of float64 at fixed parameters; the float32
   fit's reconstruction error within 1e-2 (relative) of the float64
   fit's; the planted centres recovered within a grid step by float32
   for at least 90% of those float64 recovers; seconds, peak memory,
   launches and syncs of an iteration.
30. ``HTFA`` on 20 subjects x 65,536 voxels x 300 TRs, float32, centres
   jittered around a planted template, K=50, soft-L1, the default
   ratios and caps (5,000 voxels x 30 TRs a subsample), 2 x 2
   iterations (a depth cut of the default 10 x 10, forced by the run's
   time limit): the fit on a 4-position subject mesh of
   the card bit for bit the meshless one, the float32 template centres
   within 3 mm of a float64 fit's (matched), template recovery, the
   seconds, launches and syncs of a subject step (one host L-BFGS a
   subject); phase 23's two-rank fit bit for bit the one-process fit.
31. The encoding tier: ``RidgeEncoder`` at T=4,000, F=2,048, V=65,536,
   the default 7 lambdas, 5 folds, ``lambda_block=2``: ``cv_scores_``
   within 1e-4, ``lambda_`` equal on >= 99% and ``W_`` within 1e-3 of
   max|W| of a float64 Cholesky CV on the card for 2,048 voxels; on a
   4-position voxel mesh of the card with the distla budget at 1 MiB,
   its Gram on the SUMMA ring (16 K5 launches: row
   ``ring_mma_ridge``), ``lambda_`` equal to the meshless fit's on >=
   99% and ``W_`` within 1e-3 of max|W|; ``BandedRidgeEncoder`` at
   F=1,024 in two bands of 512, 49 candidates, ``candidate_block=4``:
   ``lambda_`` rows equal to the float64 CV's on >= 99% of 2,048
   voxels; fit seconds and peak memory, the launches and syncs of a
   sweep block.
32. ``MatnormalRegression`` (run, as 33-34, after phase 31): T=600 in
   two runs (``CovAR1(600, scan_onsets=[0, 300])``), 16 conditions, a
   16 x 16 x 8 voxel box with ``CovKroneckerFactored([16, 16, 8],
   mask=)``, the mask the inscribed ellipsoid (1,104 voxels); planted
   beta, AR(1) noise (rho 0.5) smooth in space; fits in float32 and
   float64 on the card (300 L-BFGS iterations at most): the float64
   loss at the float32 optimum within 1e-4 of the float64 optimum's,
   corr(beta-hat, beta) > 0.9 over the kept voxels, rho-hat and
   ``calibrate``'s corr with the design printed, max|beta32 - beta64| /
   max|beta64|; seconds, iterations, peak memory, the launches and
   syncs of an iteration (profiled fits of 2 iterations less 1).
33. ``MNRSA``: the same T and runs, V=2,048 with ``CovDiagonal``, 16
   conditions whose U has 4 blocks of 4 (0.8 inside a block),
   ``n_nureg=5``, fits in float32 and float64 (1,000 L-BFGS iterations
   at most: at 300 the fits stop short of the optimum): the same loss
   gate, the off-diagonal corr of ``C_`` with U > 0.7, max|U32 - U64|
   / max|U64|, and the same timings.
34. ``InvertedEncoding1D`` (6 channels, half-circular) and
   ``InvertedEncoding2D`` (an 8 x 8 square grid over [-6, 6] x [-5, 5]
   at 121 x 101 pixels) on 480 trials x 2,000 voxels, 360 to train and
   120 to test, in float32 and float64: median held-out errors under
   20 degrees and 2.0 units, float32 predictions equal to float64's on
   >= 95%; then ``fmin`` with 40 evaluations over the 2-D model's
   channel FWHM in [1, 2.5], each a float32 fit and a held-out score on
   the card (the training discs' masks made once).
35. The fMRI simulator (``utils/fmrisim.py``; draws on the host,
   arithmetic on the card in float64): ``generate_noise`` at 24 x 24 x
   16, 60 TRs, matched, from ``np.random.seed(SEED + 81)`` on the card
   and on the CPU, within 1e-9 of max|noise|, the fit loops reading
   their stopping rule as many times, the calibrated exponents equal;
   ``generate_stream(rng=SEED)`` at the default settings likewise.  Then
   a 3 mm EPI run, 64 x 64 x 36 voxels x 300 TRs, TR 2 s, matched to
   SFNR 90 and SNR 50 with drift 1 and AR(1) 0.5: noise >= 0, the
   brain's mean over 10 times the rest's, its SNR and SFNR within
   0.3x-3x of target, one host sync a fit iteration (sync debug mode);
   ``calc_noise`` of it: AR within 0.15 of 0.5, FWHM within 35% of 4;
   seconds split into host draws, uploads and the rest, peak memory,
   and one profiled temporal fit iteration's device time and launches.
26. The ingest split: one ``normalize_epochs`` call on 32 whole-brain
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


def whole_brain_inputs(rng):
    """Phase 3's images, condition specs and mask1 from ``rng``: 8
    subjects x 600 TRs on a 64x64x16 volume, mask1 1,024 voxels, the
    first 16 of them coupled in condition 1 to 2,048 others."""
    shape = (64, 64, 16)
    order = rng.permutation(int(np.prod(shape)))
    sel, planted_v = np.sort(order[:1024]), order[1024:3072]
    images, conditions = synthetic_images(rng, 8, shape, 600, sel[:16],
                                          planted_v)
    mask1 = np.zeros(shape, dtype=bool)
    mask1.flat[sel] = True
    return images, conditions, mask1


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
             n_check, prep_records=None):
    """One FCMA path: ``prepare_fcma_data`` then ``run('svm')``, cold
    and warm.  With a ``prep_records`` list, a MemorySink is on while
    ``prepare_fcma_data`` runs and its records are added to the list."""
    from brainiak_tpu_torch import obs
    from brainiak_tpu_torch.fcma import prepare_fcma_data
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector
    from brainiak_tpu_torch.ops import fcma_kernels as fk
    from brainiak_tpu_torch.ops.kernels import epoch_norm as en

    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    en.reset_launches()
    mem = obs.add_sink(obs.MemorySink()) if prep_records is not None \
        else None
    t0 = time.perf_counter()
    raw1, raw2, labels = prepare_fcma_data(images, conditions, mask1,
                                           mask2)
    t_prep = time.perf_counter() - t0
    if mem is not None:
        obs.remove_sink(mem)
        prep_records.extend(mem.records)
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
    return vs, accs, launches, results


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
#: is the other subjects' mean), a step of path C's ring on phase
#: 23's two ranks (each rank's half of the voxels, the panel its
#: peer's half), and a step of phase 31's ring Gram of the ridge's
#: design (T=4,000, F=2,048 over 4 positions)
RING_SHAPES = {
    "ring_mma": (600, 65536, 65536, 1, 0, 3, True, ("tc", "ffma")),
    "ring_mma_n4": (600, 16384, 16384, 4, 2, 5, False, ("tc",)),
    "ring_mma_v8192": (600, 8192, 8192, 1, 0, 10, False, ("tc",)),
    "ring_mma_v4096": (600, 4096, 4096, 2, 1, 10, False, ("tc",)),
    "ring_mma_ridge": (4000, 512, 512, 4, 1, 10, False, ("tc",))}


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
    from brainiak_tpu_torch import obs
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
    mem = obs.add_sink(obs.MemorySink())
    t0 = time.perf_counter()
    out = distla.gram(data, mesh=mesh1)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    obs.remove_sink(mem)
    check_spans("ring path A", mem.records, [
        ("distla.gram", "", {"n_voxels": n_v, "n_shards": 1,
                             "kind": "summa"})])
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


def isfc_data(n_s, n_t, n_v):
    """[T, V, S] float32: one shared signal plus noise a subject, from
    the seed of ring path C."""
    rng = np.random.default_rng(SEED + 5)
    signal = rng.standard_normal((n_t, n_v), dtype=np.float32)
    return np.stack([signal + rng.standard_normal((n_t, n_v),
                                                  dtype=np.float32)
                     for _ in range(n_s)], axis=2)


def run_isfc_path(torch, rows, n_s=8, n_t=600, n_v=8192):
    """Ring path C: leave-one-out ISFC of 8 subjects x 600 TRs on the
    one-mask volume (32x32x8, 8,192 voxels) on the one-card mesh,
    against the dense path, then isc."""
    from brainiak_tpu_torch import isc as tisc
    from brainiak_tpu_torch.ops.kernels import ring as kr
    from brainiak_tpu_torch.parallel import make_mesh

    data = isfc_data(n_s, n_t, n_v)
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


# -- observability and the resilient-fit contract ---------------------

FIT_NAME = "fit_contract"


def check_spans(label, records, want):
    """Every record passes the port's ``validate_record``, and the span
    records are ``want``: ``[(name, parent path, attrs)]`` in order
    (attrs None to skip them)."""
    from brainiak_tpu_torch.obs import validate_record

    for rec in records:
        errors = validate_record(rec)
        if errors:
            fail(f"{label}: a {rec.get('kind')} record {rec.get('name')!r} "
                 f"fails the record schema: {errors}")
    got = [(r["name"], r["path"].rpartition("/")[0], r.get("attrs"))
           for r in records if r["kind"] == "span"]
    if len(got) != len(want) or any(
            g[:2] != w[:2] or (w[2] is not None and g[2] != w[2])
            for g, w in zip(got, want)):
        fail(f"{label}: spans {got}, want {want}")
    log(f"  {label}: spans {[(n, p) for n, p, _ in got]}, "
        f"{len(records)} records, all valid")


def launch_counts(torch, prof):
    """(kernel launches the host made, kernels the device ran) in a
    finished profile, from its raw events: the host's count is the
    runtime's launch calls, which the device activity buffers cannot
    drop."""
    host = device = 0
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith(("Memcpy", "Memset", "ProfilerStep")):
                device += 1
        elif "LaunchKernel" in name:
            host += 1
    return host, device


def run_obs_cost(torch, vs, prep_records, smi):
    """The whole-brain selection with obs disabled and with a
    MemorySink: the spans (``fcma.epoch_norm`` while preparing, then
    ``fcma.voxel_selection`` with one ``fcma.block`` and ``fcma.svm_cv``
    in it), warm seconds in turns (off, on, on, off) and the kernel
    launches of one profiled run each, which must be equal."""
    from torch.profiler import ProfilerActivity, profile

    from brainiak_tpu_torch import obs

    epoch_norm = [r for r in prep_records if r["kind"] == "span"]
    check_spans("prepare_fcma_data (whole brain)", prep_records,
                [("fcma.epoch_norm", "", None)] * max(len(epoch_norm), 1))
    n_v = vs.num_voxels
    want = [("fcma.block", "fcma.voxel_selection", {"start": 0}),
            ("fcma.svm_cv", "fcma.voxel_selection", {"n_voxels": n_v}),
            ("fcma.voxel_selection", "", {"clf": "svm", "n_voxels": n_v})]
    secs = {"off": [], "on": []}
    for lane in ("off", "on", "on", "off"):
        mem = obs.add_sink(obs.MemorySink()) if lane == "on" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vs.run('svm')
        torch.cuda.synchronize()
        secs[lane].append(time.perf_counter() - t0)
        if mem is not None:
            obs.remove_sink(mem)
            check_spans("whole brain run('svm')", mem.records, want)
    counts = {}
    for lane in ("off", "on"):
        mem = obs.add_sink(obs.MemorySink()) if lane == "on" else None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            vs.run('svm')
            torch.cuda.synchronize()
        if mem is not None:
            obs.remove_sink(mem)
        counts[lane] = launch_counts(torch, prof)
    log(f"obs cost, whole brain warm run('svm') ({smi}): obs disabled "
        f"{secs['off'][0]:.4f} s, {secs['off'][1]:.4f} s; MemorySink "
        f"{secs['on'][0]:.4f} s, {secs['on'][1]:.4f} s; kernel launches "
        f"in a profiled run (host launch calls, device kernels seen): "
        f"disabled {counts['off']}, MemorySink {counts['on']}")
    if counts["off"][0] < 1 or counts["off"][0] != counts["on"][0]:
        fail("obs changed the kernels that run('svm') launches: "
             f"{counts}")
    if counts["off"][1] != counts["on"][1]:
        log("  the profiler's device activity saw a different number of "
            "kernels in the two runs (its buffers drop records); the "
            "host's launch calls are equal")


def power_chunk(torch, g, plant=None):
    """A chunk for ``make_device_carry_chunk``: ``n_steps`` times
    ``v <- G v`` with each column scaled to unit norm; ``plant(v)``, if
    given, edits the chunk's output."""
    def chunk(leaves, n_steps):
        (v,) = leaves
        for _ in range(n_steps):
            v = g @ v
            v = v / torch.linalg.vector_norm(v, dim=0)
        return (plant(v) if plant is not None else v,)
    return chunk


def events(records, name):
    return [r for r in records if r["kind"] == "event" and r["name"] == name]


def run_fit_contract(torch, smi, dev="cuda", n_t=600, n_v=8192, n_cols=16,
                     n_iter=40, every=5):
    """The resilient-fit contract on the card: ``run_resilient_loop``
    over ``make_device_carry_chunk`` of a power iteration on the
    [n_v, n_v] Gram of one subject (``distla.gram(mesh=)``, K5), TF32
    off.  A reference run; a preempted run resumed from its checkpoint;
    a NaN rolled back; a chunk that is NaN every time, aborted; an Inf
    caught by the sanitizer lane; the memory watermark against
    ``max_memory_allocated``.  Fails on any miss."""
    import os
    import tempfile

    from brainiak_tpu_torch import obs
    from brainiak_tpu_torch.obs import flight, sanitize
    from brainiak_tpu_torch.ops import distla
    from brainiak_tpu_torch.ops.kernels import ring as kr
    from brainiak_tpu_torch.parallel import make_mesh
    from brainiak_tpu_torch.resilience import faults, guards

    rng = np.random.default_rng(SEED + 6)
    data = rng.standard_normal((n_t, n_v), dtype=np.float32)
    v0 = rng.standard_normal((n_v, n_cols), dtype=np.float32)
    kr.reset_launches()
    g = distla.gram(data, mesh=make_mesh(("voxel",), (1,), devices=[dev]),
                    force="summa", device=dev)
    torch.cuda.synchronize()
    if kr.launches() < 1 or kr.launches("tc") != kr.launches():
        fail(f"fit contract: the Gram did not run K5's tensor-core "
             f"kernel alone ({kr.launches('tc')} of {kr.launches()})")
    log(f"fit contract: G [{n_v}, {n_v}] of [{n_t}, {n_v}] by "
        f"distla.gram(mesh=), K5 launches {kr.launches('tc')}; v "
        f"[{n_v}, {n_cols}], {n_iter} steps, a chunk of {every}")

    with tempfile.TemporaryDirectory(prefix="fit_contract_") as root:
        os.environ[flight.FLIGHT_DIR_ENV] = os.path.join(root, "incidents")

        def fit(chunk_fn, sub=None, **kw):
            run_chunk, final = guards.make_device_carry_chunk(
                chunk_fn, ("v",), device=dev)
            ckpt = os.path.join(root, sub) if sub else None
            state, step = guards.run_resilient_loop(
                run_chunk, {"v": v0}, n_iter, checkpoint_every=every,
                checkpoint_dir=ckpt, name=FIT_NAME, **kw)
            return state, step, final

        def same(label, state, ref):
            diff = np.abs(state["v"].astype(np.float64) - ref)
            log(f"  {label}: bit-identical to the reference run: "
                f"{np.array_equal(state['v'], ref)} (max diff "
                f"{diff.max():.3e}, {int((diff != 0).sum())} entries differ)")
            if not np.array_equal(state["v"], ref):
                fail(f"fit contract: {label} does not reproduce the "
                     "reference run's iterates bit for bit")

        # the reference run, with a MemorySink and a measured first chunk
        growth = []
        run_chunk, final = guards.make_device_carry_chunk(
            power_chunk(torch, g), ("v",), device=dev)

        def measured(state, step, n_steps):
            before = torch.cuda.max_memory_allocated()
            out = run_chunk(state, step, n_steps)
            growth.append(torch.cuda.max_memory_allocated() - before)
            return out

        torch.cuda.reset_peak_memory_stats()
        mem = obs.add_sink(obs.MemorySink())
        t0 = time.perf_counter()
        ref, step = guards.run_resilient_loop(
            measured, {"v": v0}, n_iter, checkpoint_every=every,
            checkpoint_dir=os.path.join(root, "ref"), name=FIT_NAME)
        t_ref = time.perf_counter() - t0
        obs.remove_sink(mem)
        check_spans("fit contract, reference run", mem.records,
                    [("fit_chunk", "", None)] * (n_iter // every))
        if step != n_iter or not np.all(np.isfinite(ref["v"])):
            fail(f"fit contract: the reference run ended at {step}")
        if not torch.equal(final(ref, step)[0].cpu(),
                           torch.from_numpy(ref["v"])):
            fail("fit contract: the carried device leaves are not the "
                 "host state")
        ref = ref["v"].astype(np.float64)
        peaks = [r["value"] for r in mem.records
                 if r["kind"] == "metric" and r["name"] == "hbm_peak_bytes"]
        log(f"  watermark: hbm_peak_bytes{{estimator={FIT_NAME}}} after "
            f"the first chunk {peaks[0]:.0f} bytes, max_memory_allocated "
            f"grew {growth[0]} bytes across it")
        if not peaks[0] > 0 or peaks[0] != growth[0]:
            fail("fit contract: the watermark is not the growth of "
                 "max_memory_allocated across the first chunk")
        chunk_s = [r["chunk_s"] for r in mem.records
                   if r["kind"] == "progress"]
        ckpt_s = [r["value"] for r in mem.records
                  if r["kind"] == "metric"
                  and r["name"] == "checkpoint_seconds"]
        log(f"  reference run ({smi}): {t_ref:.4f} s; chunk seconds "
            f"{', '.join(f'{c:.5f}' for c in chunk_s)}; checkpoint_seconds "
            f"mean {np.mean(ckpt_s):.5f} max {np.max(ckpt_s):.5f} over "
            f"{len(ckpt_s)} saves of {n_v * n_cols * 4} bytes")

        # one uninterrupted run of the same steps, outside the loop
        v = torch.from_numpy(v0).to(dev)
        v = power_chunk(torch, g)((v,), n_iter)[0]
        plain = v.cpu().numpy().astype(np.float64)
        log(f"  {n_iter} steps in one chunk, outside the loop: "
            f"bit-identical to the reference run "
            f"{np.array_equal(plain, ref)} (max diff "
            f"{np.abs(plain - ref).max():.3e})")

        # preemption at step 20, then a resume from the checkpoint
        mem = obs.add_sink(obs.MemorySink())
        with faults.inject("preempt", at_step=20) as fault:
            try:
                fit(power_chunk(torch, g), "preempt")
            except faults.PreemptionError as exc:
                log(f"  preempted: {exc}")
        if fault.fired != 1:
            fail("fit contract: the preempt fault did not fire")
        resumed, step, _ = fit(power_chunk(torch, g), "preempt")
        obs.remove_sink(mem)
        resume = events(mem.records, "resume")
        if len(resume) != 1 or resume[0]["attrs"]["step"] != 20 or \
                step != n_iter:
            fail(f"fit contract: the resume is wrong: {resume}, step "
                 f"{step}")
        same("resumed at step 20", resumed, ref)

        # a NaN at step 15, rolled back
        mem = obs.add_sink(obs.MemorySink())
        with faults.inject("nan", at_step=15) as fault:
            rolled, step, _ = fit(power_chunk(torch, g))
        obs.remove_sink(mem)
        rollback = events(mem.records, "rollback")
        if fault.fired != 1 or len(rollback) != 1 or \
                rollback[0]["attrs"]["to_step"] != 10:
            fail(f"fit contract: the NaN was not rolled back once: "
                 f"{rollback}")
        same("NaN at step 15 rolled back", rolled, ref)

        # a chunk that is NaN every time: DivergenceError, a flight dump
        mem = obs.add_sink(obs.MemorySink())
        try:
            fit(power_chunk(torch, g,
                            lambda v: torch.full_like(v, float("nan"))),
                max_rollbacks=2)
        except guards.DivergenceError as exc:
            log(f"  abort: {exc}")
        obs.remove_sink(mem)
        abort = events(mem.records, "divergence_abort")
        dump = flight.last_dump(fit_id=abort[0]["fit_id"]) if abort \
            else None
        if len(abort) != 1 or len(events(mem.records, "rollback")) != 2 \
                or dump is None or dump["trigger"] != "divergence_abort" \
                or not os.path.exists(os.path.join(dump["path"],
                                                   "manifest.json")):
            fail(f"fit contract: no divergence abort with a flight dump "
                 f"({abort}, {dump})")
        log(f"  divergence_abort after 2 rollbacks, flight dump "
            f"{os.path.basename(dump['path'])}")

        # the sanitizer lane: an Inf in a CUDA output
        os.environ["BRAINIAK_TPU_SANITIZE"] = "1"
        try:
            x = torch.ones(n_cols, device=dev)
            x[3] = float("inf")
            err, _ = sanitize.call_checked(lambda t: {"v": t * 2}, (x,),
                                           site=FIT_NAME, scope="chip_smoke")
            if err is None:
                fail("fit contract: call_checked let an Inf through")
            log(f"  sanitizer on a CUDA output: {err}")
            calls = []

            def plant_once(v):
                calls.append(1)
                if len(calls) == 3:
                    v = v.clone()
                    v[0, 0] = float("inf")
                return v

            mem = obs.add_sink(obs.MemorySink())
            caught, step, _ = fit(power_chunk(torch, g, plant_once))
            obs.remove_sink(mem)
        finally:
            del os.environ["BRAINIAK_TPU_SANITIZE"]
        trips = events(mem.records, "sanitizer")
        rollback = events(mem.records, "rollback")
        if len(trips) != 1 or len(rollback) != 1 or not \
                rollback[0]["attrs"]["leaves"][0].startswith("sanitizer:"):
            fail(f"fit contract: the sanitizer lane did not trip once "
                 f"and roll back: {trips}, {rollback}")
        same("Inf caught by the sanitizer lane, rolled back", caught, ref)
        del os.environ[flight.FLIGHT_DIR_ENV]
    del g
    torch.cuda.empty_cache()


# -- SRM, the panel Gram and the FCMA file front end -------------------

# SRM at the configuration of BASELINE.md:120 (its shape only)
SRM_SUBJECTS, SRM_VOXELS, SRM_TRS, SRM_FEATURES, SRM_ITERS = \
    20, 40000, 300, 50, 10
# each float32 fit against a float64 fit of the same chunk functions on
# the card from the same w0: max|dW| / max|W|, |dS|_F / |S|_F and
# d(logprob) / |logprob| (d(objective) for DetSRM)
SRM_W_RTOL = 1e-3
SRM_S_RTOL = 1e-3
SRM_LL_RTOL = 1e-5
SRM_ORTHO = 1e-4     # max |W_i^T W_i - I|
SRM_RECOVERY = 0.9   # mean pairwise correlation of the shared responses


def srm_data(n_subj, n_vox, n_trs, k, seed):
    """X_i = W_i S + 0.1 noise, float32, with orthonormal planted W_i
    [n_vox, k] and S [k, n_trs], from a numpy seed."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((k, n_trs), dtype=np.float32)
    X, W = [], []
    for _ in range(n_subj):
        q, _ = np.linalg.qr(rng.standard_normal((n_vox, k),
                                                dtype=np.float32))
        x = q @ s
        x += np.float32(0.1) * rng.standard_normal((n_vox, n_trs),
                                                   dtype=np.float32)
        W.append(q)
        X.append(x)
    return X, W, s


def timed_fit(torch, srm, fit, em_name, module=None):
    """``fit()`` with its steps timed: the host stack and pad, the
    upload, the init (a CPU draw and a QR on the card), the EM by CUDA
    events around ``<module>.<em_name>`` (``module`` by default
    ``srm``; then a synchronize, so that what follows is the fetch
    alone) and the fetch with the host checks.  Returns (model,
    seconds by step, EM device ms, the EM's arguments: the data,
    traces, voxel counts and w0 on the card, or the data and w0)."""
    module = module or srm
    real = {n: getattr(srm, n) for n in ("_stack_and_pad", "_init_w")}
    real_em = getattr(module, em_name)
    real_place = srm._SRMBase._device_place
    marks = {}

    def host_timed(name, fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        marks[name] = time.perf_counter() - t0
        return out

    def em(*a, **k):
        marks["em_args"] = a
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = real_em(*a, **k)
        stop.record()
        torch.cuda.synchronize()
        marks["em"] = time.perf_counter() - t0
        marks["em_ms"] = start.elapsed_time(stop)
        marks["t_em_end"] = time.perf_counter()
        return out

    srm._stack_and_pad = lambda *a, **k: host_timed(
        "stack", real["_stack_and_pad"], *a, **k)
    srm._init_w = lambda *a, **k: host_timed("init", real["_init_w"],
                                             *a, **k)
    srm._SRMBase._device_place = lambda self, *a: host_timed(
        "upload", real_place, self, *a)
    setattr(module, em_name, em)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = fit()
        t_end = time.perf_counter()
    finally:
        for name, fn in real.items():
            setattr(srm, name, fn)
        setattr(module, em_name, real_em)
        srm._SRMBase._device_place = real_place
    secs = {k: marks[k] for k in ("stack", "upload", "init", "em")}
    secs["fetch"] = t_end - marks["t_em_end"]
    secs["total"] = t_end - t0
    return model, secs, marks["em_ms"], marks["em_args"]


def srm_reference(torch, srm, X, kind, w0, n_iter, dev):
    """The float64 fit of the same chunk functions on the card from
    ``w0``: (w [S, V, K], shared, logprob or objective), on the host."""
    stacked, counts, _, trace = srm._stack_and_pad(
        X, np.float64, demean=kind == "SRM")
    x = torch.from_numpy(stacked).to(dev)
    w0 = w0.to(dev, torch.float64)
    if kind == "SRM":
        w, _, _, shared, ll = srm._fit_prob_srm(
            x, torch.from_numpy(trace).to(dev),
            torch.from_numpy(counts.astype(np.float64)).to(dev), w0,
            n_iter)
    else:
        w, shared, ll = srm._fit_det_srm(x, w0, n_iter)
    out = (w.cpu().numpy(), shared.cpu().numpy(), float(ll))
    del x, w0, w, shared
    return out


def srm_errors(model, ref, kind):
    """(max|dW| / max|W|, |dS|_F / |S|_F, d(objective) / |objective|)
    of a fitted model against a reference ``(w, shared, objective)``
    (``w`` padded, or a list)."""
    w_ref, s_ref, ll_ref = ref
    dw = max(float(np.abs(w - w_ref[i][:w.shape[0]]).max())
             for i, w in enumerate(model.w_))
    wmax = max(float(np.abs(w_ref[i][:w.shape[0]]).max())
               for i, w in enumerate(model.w_))
    ds = float(np.linalg.norm(model.s_ - s_ref) / np.linalg.norm(s_ref))
    ll = model.logprob_ if kind == "SRM" else model.objective_
    return dw / wmax, ds, abs(ll - ll_ref) / abs(ll_ref)


def srm_checks(label, model, X, W, kind, ref, rtols=None):
    """Hold a fit to its reference (``rtols``: the three bounds), to
    orthonormal maps and to the planted structure; log the figures."""
    rw, rs, rl = srm_errors(model, ref, kind)
    ortho = max(float(np.abs(w.T @ w - np.eye(w.shape[1])).max())
                for w in model.w_)
    shared = model.transform(X)
    corr = [np.corrcoef(shared[i].ravel(), shared[j].ravel())[0, 1]
            for i in range(len(X)) for j in range(i + 1, len(X))]
    cos = np.concatenate([np.linalg.svd(w.T @ p[:w.shape[0]],
                                        compute_uv=False)
                          for w, p in zip(model.w_, W)])
    log(f"  {label}: vs float64 on the card max|dW|/max|W| {rw:.3e}, "
        f"|dS|/|S| {rs:.3e}, d{'logprob' if kind == 'SRM' else 'obj'}"
        f"/|.| {rl:.3e}; max|W^T W - I| {ortho:.3e}; mean pairwise "
        f"shared-response correlation {np.mean(corr):.5f}; cosines of "
        f"the principal angles to the planted W_i: smallest "
        f"{cos.min():.5f}, median {np.median(cos):.5f}, "
        f"{int(np.sum(cos < 0.9))} of {cos.size} below 0.9")
    tw, ts, tl = rtols or (SRM_W_RTOL, SRM_S_RTOL, SRM_LL_RTOL)
    if not (rw <= tw and rs <= ts and rl <= tl):
        fail(f"{label}: the float32 fit is off its float64 reference "
             f"({rw:.3e}, {rs:.3e}, {rl:.3e} against {tw}, {ts}, {tl})")
    if ortho > SRM_ORTHO:
        fail(f"{label}: the maps are not orthonormal ({ortho:.3e})")
    if not np.mean(corr) > SRM_RECOVERY:
        fail(f"{label}: the shared responses do not agree "
             f"({np.mean(corr):.4f})")


def count_syncs(torch, fn):
    """(host syncs, {python line: count}) of one ``fn()`` under
    ``torch.cuda.set_sync_debug_mode("warn")``: one warning for each
    operation that waits for the card."""
    import collections
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    hits = [w for w in caught if "synchroniz" in str(w.message)]
    where = collections.Counter(
        f"{w.filename.rpartition('/')[2]}:{w.lineno}" for w in hits)
    return len(hits), dict(where)


def srm_sync_and_profile(torch, srm, em_args, smi, n_iter):
    """The syncs of each solve the EM calls, and of one and two EM
    iterations; then one profiled run of ``n_iter`` EM iterations: the
    top device ops, the launches an iteration and the busy share.
    ``em_args``: the data, traces, voxel counts and w0 of a fit."""
    x, trace, counts, w0 = em_args[:4]
    dev = w0.device
    k = w0.shape[2]
    n_s = w0.shape[0]
    state = (w0, torch.ones(n_s, device=dev), torch.eye(k, device=dev),
             torch.zeros((k, x.shape[2]), device=dev))
    gram = torch.randn(n_s, k, k, device=dev)
    gram = gram @ gram.transpose(1, 2) + torch.eye(k, device=dev)
    solves = {
        "linalg.eigh [S, K, K]": lambda: torch.linalg.eigh(gram),
        "linalg.cholesky_ex + cholesky_solve [K, K]":
            lambda: torch.cholesky_solve(
                torch.eye(k, device=dev),
                torch.linalg.cholesky_ex(gram[0])[0]),
        "linalg.qr [S, V, K] (the init)":
            lambda: torch.linalg.qr(w0),
        "linalg.svd [V, K] (transform_subject)":
            lambda: torch.linalg.svd(w0[0], full_matrices=False),
    }
    for name, fn in solves.items():
        n, where = count_syncs(torch, fn)
        log(f"  host syncs of {name}: {n}")
    bcd_profile(torch, "SRM EM",
                lambda n: srm._em_chunk(x, trace, counts, *state,
                                        n_steps=n), n_iter, smi, top=8)
    del x, state, gram


def run_srm(torch, smi, dev="cuda", shape=None, data=None, keep=None):
    """SRM and DetSRM at BASELINE.md:120's shape (20 subjects x 40,000
    voxels x 300 TRs, 50 features, 10 iterations, float32), and a
    ragged SRM fit, each once: ``run_srm_contract`` runs first, so
    cuSOLVER's and cuBLAS's first calls are behind them.  Each is held
    to a float64 fit of the same chunk functions on the card, to
    orthonormal maps and to the planted structure; each fit's split
    and peak memory, and the SRM EM's syncs and profile are printed.
    ``data``: ``srm_data``'s output at that shape (made here if
    None).  ``keep``: a dict that takes the SRM and DetSRM fits' W
    (stacked), S and objective, and their float64 references' (keys
    ``"SRM_f64"``, ``"DetSRM_f64"``), for phase 23."""
    from brainiak_tpu_torch.funcalign import srm

    n_s, n_v, n_t, k, n_iter = shape or (
        SRM_SUBJECTS, SRM_VOXELS, SRM_TRS, SRM_FEATURES, SRM_ITERS)
    t0 = time.perf_counter()
    X, W, _ = data or srm_data(n_s, n_v, n_t, k, SEED + 7)
    log(f"SRM: {n_s} subjects x {n_v} voxels x {n_t} TRs, K={k}, "
        f"{n_iter} iterations, float32 ({n_s * n_v * n_t * 4 / 1e9:.2f} "
        f"GB stack; data made in {time.perf_counter() - t0:.2f} s)")
    ragged = [x[:n_v - 500 * i] for i, x in enumerate(X)]
    for label, kind, data in (("SRM", "SRM", X), ("DetSRM", "DetSRM", X),
                              (f"SRM ragged, V_i = {n_v} - 500 i", "SRM",
                               ragged)):
        em_name = "_fit_prob_srm" if kind == "SRM" else "_fit_det_srm"
        cls = getattr(srm, kind)
        torch.cuda.reset_peak_memory_stats()
        model, secs, em_ms, em_args = timed_fit(
            torch, srm,
            lambda: cls(n_iter=n_iter, features=k, device=dev).fit(data),
            em_name)
        peak = torch.cuda.max_memory_allocated()
        log(f"  {label}: fit ({smi}) {secs['total']:.3f} s = stack and "
            f"pad {secs['stack']:.3f} + upload {secs['upload']:.3f} + "
            f"init {secs['init']:.3f} + EM {secs['em']:.3f} (device "
            f"{em_ms:.3f} ms by CUDA events) + fetch "
            f"{secs['fetch']:.3f} + the rest; peak device memory "
            f"{peak / 2**30:.2f} GiB")
        w0 = em_args[3] if kind == "SRM" else em_args[1]
        ref = srm_reference(torch, srm, data, kind, w0, n_iter, dev)
        srm_checks(label, model, data, W, kind, ref)
        if label == "SRM":
            srm_sync_and_profile(torch, srm, em_args, smi, n_iter)
        if keep is not None and kind == label:
            keep[kind] = (np.stack(model.w_), model.s_,
                          model.logprob_ if kind == "SRM"
                          else model.objective_)
            keep[kind + "_f64"] = ref
        del model, em_args, w0, ref
        torch.cuda.empty_cache()


def resume_and_rollback(label, fit, same, ref):
    """A fit preempted at step 10 and resumed, and a NaN at step 5
    rolled back to step 0, each held to ``ref`` by ``same(what, got,
    ref)``; ``fit(sub)`` fits with a checkpoint directory named
    ``sub``, a checkpoint every 5 steps."""
    from brainiak_tpu_torch import obs
    from brainiak_tpu_torch.resilience import faults

    with faults.inject("preempt", at_step=10) as fault:
        try:
            fit("preempt")
        except faults.PreemptionError as exc:
            log(f"  preempted: {exc}")
    if fault.fired != 1:
        fail(f"{label}: the preempt fault did not fire")
    mem = obs.add_sink(obs.MemorySink())
    resumed = fit("preempt")
    obs.remove_sink(mem)
    resume = events(mem.records, "resume")
    if len(resume) != 1 or resume[0]["attrs"]["step"] != 10:
        fail(f"{label}: the resume is wrong: {resume}")
    same("resumed at step 10", resumed, ref)
    mem = obs.add_sink(obs.MemorySink())
    with faults.inject("nan", at_step=5) as fault:
        rolled = fit("nan")
    obs.remove_sink(mem)
    rollback = events(mem.records, "rollback")
    if fault.fired != 1 or len(rollback) != 1 or \
            rollback[0]["attrs"]["to_step"] != 0:
        fail(f"{label}: the NaN was not rolled back once: {rollback}")
    same("NaN at step 5 rolled back", rolled, ref)


def run_srm_contract(torch, smi, dev="cuda", n_s=8, n_v=8192, n_t=300,
                     k=50, n_iter=20, every=5):
    """The SRM fit contract on the card: the checkpointed fit against
    the plain fit, a fit preempted at step 10 and resumed, and a NaN at
    step 5 rolled back, each held to the uninterrupted checkpointed fit
    bit for bit; its chunk and checkpoint seconds."""
    import os
    import tempfile

    from brainiak_tpu_torch import obs
    from brainiak_tpu_torch.funcalign import srm

    X, _, _ = srm_data(n_s, n_v, n_t, k, SEED + 8)

    def same(label, got, ref):
        equal = all(np.array_equal(a, b) for a, b in zip(got.w_, ref.w_)) \
            and np.array_equal(got.s_, ref.s_) \
            and np.array_equal(got.rho2_, ref.rho2_) \
            and got.logprob_ == ref.logprob_
        log(f"  {label}: bit-identical to the uninterrupted "
            f"checkpointed fit: {equal}")
        if not equal:
            fail(f"SRM fit contract: {label} is not the uninterrupted "
                 "checkpointed fit bit for bit")

    with tempfile.TemporaryDirectory(prefix="srm_contract_") as root:
        def fit(sub=None):
            kw = {} if sub is None else dict(
                checkpoint_dir=os.path.join(root, sub),
                checkpoint_every=every)
            return srm.SRM(n_iter=n_iter, features=k, device=dev).fit(
                X, **kw)

        plain = fit()
        mem = obs.add_sink(obs.MemorySink())
        t0 = time.perf_counter()
        ref = fit("ref")
        t_ref = time.perf_counter() - t0
        obs.remove_sink(mem)
        chunk_s = [r["chunk_s"] for r in mem.records
                   if r["kind"] == "progress"]
        ckpt_s = [r["value"] for r in mem.records
                  if r["kind"] == "metric"
                  and r["name"] == "checkpoint_seconds"]
        spans = [r for r in mem.records if r["kind"] == "span"]
        log(f"SRM fit contract ({smi}): {n_s} subjects x {n_v} voxels x "
            f"{n_t} TRs, K={k}, {n_iter} iterations, a checkpoint every "
            f"{every}: {t_ref:.4f} s; chunk seconds "
            f"{', '.join(f'{c:.5f}' for c in chunk_s)}; "
            f"checkpoint_seconds mean {np.mean(ckpt_s):.5f} max "
            f"{np.max(ckpt_s):.5f} over {len(ckpt_s)} saves of "
            f"{n_s * n_v * k * 4} bytes of W; {len(spans)} fit_chunk "
            f"spans")
        if len(spans) != n_iter // every or \
                any(s["name"] != "fit_chunk" for s in spans):
            fail(f"SRM fit contract: spans {spans}")
        rw, rs, rl = srm_errors(plain, ([w for w in ref.w_], ref.s_,
                                        ref.logprob_), "SRM")
        log(f"  checkpointed vs plain fit: max|dW|/max|W| {rw:.3e}, "
            f"|dS|/|S| {rs:.3e}, dlogprob/|.| {rl:.3e}")
        if not (rw <= SRM_W_RTOL and rs <= SRM_S_RTOL and
                rl <= SRM_LL_RTOL):
            fail("SRM fit contract: the checkpointed fit is off the "
                 "plain fit")
        resume_and_rollback("SRM fit contract", fit, same, ref)
    torch.cuda.empty_cache()


def run_panel_gram(torch, smi, dev="cuda", n_t=600, n_v=8192):
    """``distla.panel_gram`` of one [n_t, n_v] subject on a 4-position
    mesh of the card, a checkpoint every panel, preempted after panel 2
    and resumed; held against ``distla.gram`` to K5_ATOL and against an
    uninterrupted panel Gram bit for bit."""
    import tempfile

    from brainiak_tpu_torch import obs
    from brainiak_tpu_torch.ops import distla
    from brainiak_tpu_torch.parallel import make_mesh
    from brainiak_tpu_torch.resilience import faults

    rng = np.random.default_rng(SEED + 9)
    data = rng.standard_normal((n_t, n_v), dtype=np.float32)
    mesh = make_mesh(("voxel",), (4,), devices=[dev] * 4)
    with tempfile.TemporaryDirectory(prefix="panel_gram_") as root:
        with faults.inject("preempt", at_step=2) as fault:
            try:
                distla.panel_gram(data, mesh, checkpoint_dir=root)
            except faults.PreemptionError as exc:
                log(f"panel Gram: preempted: {exc}")
        if fault.fired != 1:
            fail("panel Gram: the preempt fault did not fire")
        mem = obs.add_sink(obs.MemorySink())
        t0 = time.perf_counter()
        got = distla.panel_gram(data, mesh, checkpoint_dir=root)
        t_resume = time.perf_counter() - t0
        obs.remove_sink(mem)
    panels = [r["attrs"]["panel"] for r in mem.records
              if r["kind"] == "span" and r["name"] == "distla.panel_chunk"]
    resume = events(mem.records, "resume")
    t0 = time.perf_counter()
    whole = distla.panel_gram(data, mesh)
    t_whole = time.perf_counter() - t0
    want = distla.gram(data, device=dev).cpu().numpy()
    err = float(np.abs(got - want).max())
    log(f"  panel Gram [{n_t}, {n_v}] on 4 positions of the card ({smi}):"
        f" resumed at panel {resume[0]['attrs']['step'] if resume else None}"
        f" (panels run {panels}) in {t_resume:.3f} s; uninterrupted, no "
        f"checkpoint {t_whole:.3f} s; bit-identical "
        f"{np.array_equal(got, whole)}; max |panel - distla.gram| "
        f"{err:.3e}")
    if len(resume) != 1 or panels != [2, 3] or \
            not np.array_equal(got, whole) or not err <= K5_ATOL:
        fail("panel Gram: the resumed Gram is wrong")
    torch.cuda.empty_cache()


def run_file_front_end(torch, images, conditions, mask1, results, smi):
    """The whole-brain path from files: the subjects written as
    uncompressed ``.nii`` by ``io.save_as_nifti_file`` with both masks
    and the epoch specs, read back by ``io.load_images_from_dir``,
    ``load_boolean_mask`` and ``load_labels``, then
    ``prepare_fcma_data`` and ``run('svm')``: its results must be the
    in-memory run's ``results`` exactly."""
    import os
    import tempfile

    from brainiak_tpu_torch import io
    from brainiak_tpu_torch.fcma import prepare_fcma_data
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector

    affine = np.diag([3.0, 3.0, 3.0, 1.0])
    shape = mask1.shape
    with tempfile.TemporaryDirectory(prefix="fcma_files_") as root:
        t0 = time.perf_counter()
        for i, img in enumerate(images):
            io.save_as_nifti_file(img, affine,
                                  os.path.join(root, f"sub{i:02d}_bet.nii"))
        io.save_as_nifti_file(mask1.astype(np.uint8), affine,
                              os.path.join(root, "mask1.nii"))
        io.save_as_nifti_file(np.ones(shape, np.uint8), affine,
                              os.path.join(root, "mask2.nii"))
        np.save(os.path.join(root, "labels.npy"), np.stack(conditions))
        t_write = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(os.path.join(root, f))
                      for f in os.listdir(root))
        t0 = time.perf_counter()
        loaded = list(io.load_images_from_dir(root, "bet.nii"))
        m1 = io.load_boolean_mask(os.path.join(root, "mask1.nii"))
        m2 = io.load_boolean_mask(os.path.join(root, "mask2.nii"))
        specs = io.load_labels(os.path.join(root, "labels.npy"))
        t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw1, raw2, labels = prepare_fcma_data(loaded, specs, m1, m2)
    t_prep = time.perf_counter() - t0
    del loaded
    got = VoxelSelector(labels, 4, 4, raw1, raw_data2=raw2).run('svm')
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0 - t_prep
    log(f"FCMA file front end ({smi}): {len(images)} subjects written as "
        f".nii ({n_bytes / 1e9:.3f} GB) in {t_write:.2f} s, read back "
        f"(images, both masks, epoch specs) in {t_read:.2f} s; prepare "
        f"{t_prep:.2f} s, run('svm') {t_run:.2f} s; results equal to the "
        f"in-memory run's: {got == results}")
    if not np.array_equal(m1, mask1) or got != results:
        fail("the file front end does not reproduce the in-memory run")


# -- the SRM family beyond SRM: RSRM, SS-SRM, FastSRM ------------------

# RSRM: phase 14's data plus a planted sparse term, 1% of each
# subject's entries at +-5; the float32 fit against a float64 fit of
# the same chunk functions on the card from the same w0
RSRM_GAMMA = 1.0
RSRM_PLANT_SHARE, RSRM_PLANT_AMP = 0.01, 5.0
RSRM_W_RTOL = 1e-3     # max|dW| / max|W|
RSRM_R_RTOL = 1e-3     # |dR|_F / |R|_F
RSRM_OBJ_RTOL = 1e-5   # d(objective) / |objective|
RSRM_SUPPORT = 0.999   # share of the entries of s_ whose support agrees
RSRM_PLANT_RATIO = 5.0  # mean |s_| on the planted entries over the rest
RSRM_NONZERO = 0.2     # most share of nonzero entries of s_
# SS-SRM at the layout of the raider data the reference's image
# prediction example loads: subjects, ventral-temporal voxels,
# alignment TRs, labelled samples a subject (and as many held out),
# classes, K, BCD iterations
SSSRM_SHAPE = (10, 1000, 2203, 56, 7, 50, 10)
SSSRM_ALPHA, SSSRM_GAMMA = 0.5, 1.0
SSSRM_ACCURACY = 0.8   # held-out accuracy (the example's gate)
SSSRM_AGREE = 0.95     # held-out predictions equal to the float64 fit's
# FastSRM on phase 14's data in two sessions of 150 TRs
FASTSRM_PARCELS, FASTSRM_ITERS = 1000, 100
FASTSRM_COSINE = 0.8   # smallest principal cosine to the planted S
FASTSRM_BASIS_RTOL = 1e-3  # max|dB| / max|B| against the float64 fit
FASTSRM_PATH_ATOL = 1e-4   # the .npy fit against the in-memory fit
FASTSRM_PATH_SUBJECTS = 4


def plant_sparse(X, seed):
    """Copies of ``X`` with a sparse term: about a share
    RSRM_PLANT_SHARE of each subject's entries (flat indices drawn from
    the seed, repeats dropped) moved by +-RSRM_PLANT_AMP.  Returns
    (planted copies, each subject's flat indices)."""
    rng = np.random.default_rng(seed)
    out, where = [], []
    for x in X:
        idx = np.unique(rng.integers(0, x.size,
                                     size=int(RSRM_PLANT_SHARE * x.size)))
        y = x.copy()
        y.ravel()[idx] += np.where(rng.random(idx.size) < 0.5, -1.0,
                                   1.0).astype(np.float32) * \
            np.float32(RSRM_PLANT_AMP)
        out.append(y)
        where.append(idx)
    return out, where


def bcd_profile(torch, label, step, n_iter, smi, top=6):
    """The host syncs of 1 and 2 iterations of ``step(n)``, then one
    profiled run of ``n_iter``: top device ops, launches an iteration,
    busy share.  Returns (syncs an iteration, launches an iteration,
    busy share)."""
    from torch.profiler import ProfilerActivity, profile

    per = {}
    for n in (1, 2):
        per[n], where = count_syncs(torch, lambda: step(n))
        log(f"  {label}: host syncs of {n} iteration(s): {per[n]} at "
            f"{where}")
    step(n_iter)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(n_iter)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted(((us, n, name) for name, (us, n)
                      in device_events(torch, prof)), reverse=True)
    host, _ = launch_counts(torch, prof)
    busy = sum(us for us, _, _ in kernels) / 1e3
    log(f"  {label} profile ({smi}): {n_iter} iterations in a "
        f"{wall_ms:.3f} ms window, device busy {busy:.3f} ms "
        f"({busy / max(wall_ms, 1e-9):.3f}); {host} host launches, "
        f"{host / n_iter:.1f} an iteration; host syncs an iteration "
        f"{per[2] - per[1]}")
    for us, n, name in kernels[:top]:
        log(f"    {us / 1e3:9.3f} ms {n:6d}x {name[:80]}")
    return per[2] - per[1], host / n_iter, busy / max(wall_ms, 1e-9)


def run_rsrm(torch, smi, dev="cuda", shape=None, data=None, keep=None):
    """RSRM at phase 14's shape (20 subjects x 40,000 voxels x 300
    TRs, K=50, 10 iterations, gamma 1, float32) on phase 14's data
    (``data``, made here if None) with a planted sparse term: held to
    a float64 fit of the same chunk functions on the card from the
    same w0, to orthonormal maps and to the planted structure; its
    seconds split, peak memory, syncs and profile.  ``keep``: a dict
    that takes the fit's W (stacked), R and objective, and the float64
    fit's (key ``"RSRM_f64"``), for phase 23."""
    from brainiak_tpu_torch.funcalign import rsrm, srm

    n_s, n_v, n_t, k, n_iter = shape or (
        SRM_SUBJECTS, SRM_VOXELS, SRM_TRS, SRM_FEATURES, SRM_ITERS)
    t0 = time.perf_counter()
    X, _, _ = data or srm_data(n_s, n_v, n_t, k, SEED + 7)
    X, planted = plant_sparse(X, SEED + 10)
    log(f"RSRM: {n_s} subjects x {n_v} voxels x {n_t} TRs, K={k}, "
        f"{n_iter} iterations, gamma {RSRM_GAMMA}, float32, "
        f"{RSRM_PLANT_SHARE:.0%} of the entries planted at "
        f"+-{RSRM_PLANT_AMP} (data made in "
        f"{time.perf_counter() - t0:.2f} s)")
    torch.cuda.reset_peak_memory_stats()
    model, secs, bcd_ms, args = timed_fit(
        torch, srm, lambda: rsrm.RSRM(n_iter=n_iter, features=k,
                                      gamma=RSRM_GAMMA,
                                      device=dev).fit(X),
        "_fit_rsrm", module=rsrm)
    peak = torch.cuda.max_memory_allocated()
    log(f"  RSRM fit ({smi}): {secs['total']:.3f} s = stack and pad "
        f"{secs['stack']:.3f} + upload {secs['upload']:.3f} + init "
        f"{secs['init']:.3f} + BCD {secs['em']:.3f} (device "
        f"{bcd_ms:.3f} ms by CUDA events) + fetch {secs['fetch']:.3f} + "
        f"the rest; peak device memory {peak / 2**30:.2f} GiB")
    # the float64 fit from the same w0 on the same (float32) stack,
    # the supports compared on the card
    x, w0 = args[0], args[1]
    w, s, r, obj = rsrm._fit_rsrm(x.to(torch.float64),
                                  w0.to(torch.float64), RSRM_GAMMA, n_iter)
    w_ref, r_ref, obj_ref = w.cpu().numpy(), r.cpu().numpy(), float(obj)
    agree = sum(int(torch.sum((torch.from_numpy(g).to(dev) != 0) ==
                              (s[i, :g.shape[0]] != 0)))
                for i, g in enumerate(model.s_)) / \
        sum(g.size for g in model.s_)
    del w, s, r, obj
    torch.cuda.empty_cache()
    rw = max(float(np.abs(g - w_ref[i][:g.shape[0]]).max())
             for i, g in enumerate(model.w_)) / float(np.abs(w_ref).max())
    rr = float(np.linalg.norm(model.r_ - r_ref) / np.linalg.norm(r_ref))
    ro = abs(model.objective_ - obj_ref) / abs(obj_ref)
    ortho = max(float(np.abs(g.T @ g - np.eye(k)).max())
                for g in model.w_)
    on_sum = sum(float(np.abs(g.ravel()[i]).sum(dtype=np.float64))
                 for g, i in zip(model.s_, planted))
    n_on = sum(i.size for i in planted)
    all_sum = sum(float(np.abs(g).sum(dtype=np.float64))
                  for g in model.s_)
    n_all = sum(g.size for g in model.s_)
    on = on_sum / n_on
    off = max(all_sum - on_sum, 0.0) / (n_all - n_on)
    nonzero = sum(int(np.count_nonzero(g)) for g in model.s_) / n_all
    log(f"  RSRM vs float64 on the card: max|dW|/max|W| {rw:.3e}, "
        f"|dR|/|R| {rr:.3e}, dobj/|obj| {ro:.3e}, supports of s_ equal "
        f"on {agree:.6f} of the entries; max|W^T W - I| {ortho:.3e}; "
        f"mean |s_| on the planted entries {on:.4f}, elsewhere "
        f"{off:.6f} (ratio {on / off if off else np.inf:.1f}); nonzero "
        f"share {nonzero:.5f} (planted {RSRM_PLANT_SHARE})")
    if not (rw <= RSRM_W_RTOL and rr <= RSRM_R_RTOL and
            ro <= RSRM_OBJ_RTOL and agree >= RSRM_SUPPORT):
        fail(f"RSRM: the float32 fit is off its float64 reference ({rw:.3e}"
             f", {rr:.3e}, {ro:.3e}, support {agree:.6f})")
    if ortho > SRM_ORTHO:
        fail(f"RSRM: the maps are not orthonormal ({ortho:.3e})")
    if not (on > RSRM_PLANT_RATIO * off and 0 < nonzero < RSRM_NONZERO):
        fail("RSRM: the sparse term does not find the planted entries")
    if keep is not None:
        keep["RSRM"] = (np.stack(model.w_), model.r_, model.objective_)
        keep["RSRM_f64"] = (w_ref, r_ref, obj_ref)
    del model, w_ref
    s0 = torch.zeros_like(x)
    r0 = rsrm._shared_response(x, s0, w0, n_s)
    bcd_profile(torch, "RSRM BCD",
                lambda n: rsrm._rsrm_chunk(x, w0, s0, r0, RSRM_GAMMA, n),
                n_iter, smi)
    del x, w0, s0, r0, args
    torch.cuda.empty_cache()


def run_rsrm_contract(torch, smi, dev="cuda", n_s=8, n_v=8192, n_t=300,
                      k=50, n_iter=20, every=5):
    """The RSRM fit contract on the card: the checkpointed fit, a fit
    preempted at step 10 and resumed, and a NaN at step 5 rolled back,
    the last two held to the first bit for bit; chunk and checkpoint
    seconds."""
    import os
    import tempfile

    from brainiak_tpu_torch import obs
    from brainiak_tpu_torch.funcalign import rsrm

    X, _ = plant_sparse(srm_data(n_s, n_v, n_t, k, SEED + 11)[0],
                        SEED + 14)

    def same(label, got, ref):
        equal = all(np.array_equal(a, b) for a, b in zip(got.w_, ref.w_)) \
            and all(np.array_equal(a, b) for a, b in zip(got.s_, ref.s_)) \
            and np.array_equal(got.r_, ref.r_) \
            and got.objective_ == ref.objective_
        log(f"  {label}: bit-identical to the uninterrupted "
            f"checkpointed fit: {equal}")
        if not equal:
            fail(f"RSRM fit contract: {label} is not the uninterrupted "
                 "checkpointed fit bit for bit")

    with tempfile.TemporaryDirectory(prefix="rsrm_contract_") as root:
        def fit(sub):
            return rsrm.RSRM(n_iter=n_iter, features=k, gamma=RSRM_GAMMA,
                             device=dev).fit(
                X, checkpoint_dir=os.path.join(root, sub),
                checkpoint_every=every)

        mem = obs.add_sink(obs.MemorySink())
        t0 = time.perf_counter()
        ref = fit("ref")
        t_ref = time.perf_counter() - t0
        obs.remove_sink(mem)
        chunk_s = [r["chunk_s"] for r in mem.records
                   if r["kind"] == "progress"]
        ckpt_s = [r["value"] for r in mem.records
                  if r["kind"] == "metric"
                  and r["name"] == "checkpoint_seconds"]
        log(f"RSRM fit contract ({smi}): {n_s} subjects x {n_v} voxels x "
            f"{n_t} TRs, K={k}, {n_iter} iterations, a checkpoint every "
            f"{every}: {t_ref:.4f} s; chunk seconds "
            f"{', '.join(f'{c:.5f}' for c in chunk_s)}; "
            f"checkpoint_seconds mean {np.mean(ckpt_s):.5f} max "
            f"{np.max(ckpt_s):.5f} over {len(ckpt_s)} saves of "
            f"{n_s * n_v * (k + n_t) * 4} bytes of W and S")
        resume_and_rollback("RSRM fit contract", fit, same, ref)
    torch.cuda.empty_cache()


def sssrm_data(shape, seed):
    """The raider-like layout, planted as the JAX package's
    ``examples/funcalign_variants.py`` plants it: a shared response,
    orthonormal W_i, labelled and held-out samples around class
    prototypes in shared space; float32.  Returns (X, y, Z, Z_test,
    y_test)."""
    n_s, n_v, n_t, n_lab, n_cls, k, _ = shape
    rng = np.random.default_rng(seed)
    shared = rng.standard_normal((k, n_t))
    prototypes = rng.standard_normal((n_cls, k)) * 2.0
    labels = np.arange(n_lab) % n_cls
    X, Z, Zt = [], [], []
    for _ in range(n_s):
        w, _ = np.linalg.qr(rng.standard_normal((n_v, k)))
        X.append((w @ shared + 0.1 * rng.standard_normal((n_v, n_t)))
                 .astype(np.float32))
        for out in (Z, Zt):
            z = prototypes[labels].T + 0.3 * rng.standard_normal(
                (k, n_lab))
            out.append((w @ z + 0.1 * rng.standard_normal((n_v, n_lab)))
                       .astype(np.float32))
    return X, [labels] * n_s, Z, Zt, [labels] * n_s


def run_sssrm(torch, smi, dev="cuda", shape=None):
    """SS-SRM at the raider-like layout (10 subjects x 1,000 voxels x
    2,203 alignment TRs, 56 labelled samples of 7 classes and 56 held
    out a subject, K=50, 10 iterations, float32): held-out accuracy,
    orthonormal maps, predictions against a float64 fit of the port on
    the card from the same initial W; seconds of the W and MLR updates
    an iteration, their syncs and launches."""
    from torch.profiler import ProfilerActivity, profile

    from brainiak_tpu_torch.funcalign import sssrm

    shape = shape or SSSRM_SHAPE
    n_s, n_v, n_t, n_lab, n_cls, k, n_iter = shape
    X, y, Z, Zt, yt = sssrm_data(shape, SEED + 12)
    log(f"SS-SRM: {n_s} subjects x {n_v} voxels x {n_t} alignment TRs, "
        f"{n_lab} labelled samples of {n_cls} classes a subject and "
        f"{n_lab} held out, K={k}, alpha {SSSRM_ALPHA}, gamma "
        f"{SSSRM_GAMMA}, {n_iter} iterations, float32")
    real = {n: getattr(sssrm, n) for n in
            ("_fit_w_subject", "_fit_w_subject_unsup", "_fit_mlr")}
    calls = {n: [] for n in real}

    def timed(name):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            calls[name].append((time.perf_counter() - t0, a))
            return out
        return call

    for name in real:
        setattr(sssrm, name, timed(name))
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        model = sssrm.SSSRM(n_iter=n_iter, features=k, gamma=SSSRM_GAMMA,
                            alpha=SSSRM_ALPHA, device=dev).fit(X, y, Z)
        t_fit = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(sssrm, name, fn)
    peak = torch.cuda.max_memory_allocated()
    w_s = [t for t, _ in calls["_fit_w_subject"]]
    mlr_s = [t for t, _ in calls["_fit_mlr"]]
    per_it_w = [sum(w_s[i * n_s:(i + 1) * n_s]) for i in range(n_iter)]
    log(f"  SS-SRM fit ({smi}): {t_fit:.3f} s; W updates an iteration "
        f"({n_s} subjects) {', '.join(f'{t:.3f}' for t in per_it_w)} s; "
        f"MLR updates (the first before the loop) "
        f"{', '.join(f'{t:.3f}' for t in mlr_s)} s; the rest "
        f"{t_fit - sum(w_s) - sum(mlr_s):.3f} s; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    preds = model.predict(Zt)
    acc = float(np.mean([np.mean(p == t) for p, t in zip(preds, yt)]))
    ortho = max(float(np.abs(w.T @ w - np.eye(k)).max()) for w in model.w_)
    t0 = time.perf_counter()
    ref = sssrm.SSSRM(n_iter=n_iter, features=k, gamma=SSSRM_GAMMA,
                      alpha=SSSRM_ALPHA, device=dev)._fit(X, y, Z,
                                                          torch.float64)
    t_ref = time.perf_counter() - t0
    agree = float(np.mean(np.concatenate(preds) ==
                          np.concatenate(ref.predict(Zt))))
    dw = max(float(np.abs(a - b).max()) for a, b in zip(model.w_, ref.w_))
    log(f"  SS-SRM: held-out accuracy {acc:.4f}; max|W^T W - I| "
        f"{ortho:.3e}; the float64 fit ({t_ref:.3f} s) predicts the same "
        f"on {agree:.4f} of the held-out samples, max|dW| {dw:.3e}")
    if acc < SSSRM_ACCURACY:
        fail(f"SS-SRM: held-out accuracy {acc:.4f} < {SSSRM_ACCURACY}")
    if ortho > SRM_ORTHO:
        fail(f"SS-SRM: the maps are not orthonormal ({ortho:.3e})")
    if agree < SSSRM_AGREE:
        fail(f"SS-SRM: predictions agree with the float64 fit on only "
             f"{agree:.4f}")
    # the first calls: the W update of the first iteration takes the
    # Stiefel loop's 30 steps, later ones stop when no step improves
    w_args = calls["_fit_w_subject"][0][1]
    mlr_args = calls["_fit_mlr"][0][1]
    for label, fn in (("W update (subject 0, iteration 1)",
                       lambda: real["_fit_w_subject"](*w_args)),
                      ("MLR update (the first)",
                       lambda: real["_fit_mlr"](*mlr_args))):
        n_sync, where = count_syncs(torch, fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        host, _ = launch_counts(torch, prof)
        log(f"  SS-SRM {label}: {n_sync} host syncs at {where}; {host} "
            f"host launches")
    del model, ref, calls, w_args, mlr_args
    torch.cuda.empty_cache()


def principal_cosines(a, b):
    """Cosines of the principal angles between the row spaces of two
    [K, T] arrays."""
    qa, _ = np.linalg.qr(np.asarray(a, dtype=np.float64).T)
    qb, _ = np.linalg.qr(np.asarray(b, dtype=np.float64).T)
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def run_fastsrm(torch, smi, dev="cuda", shape=None, data=None,
                n_parcels=FASTSRM_PARCELS, n_iter=FASTSRM_ITERS,
                n_path=FASTSRM_PATH_SUBJECTS):
    """FastSRM on phase 14's data (``data``, made here if None), each
    subject's TRs in two sessions,
    a deterministic atlas of ``n_parcels`` parcels, K=50, ``n_iter``
    reduced-space iterations, aggregate "mean": held to the planted
    shared response, to orthonormal bases and to a float64 fit of the
    port on the card from the same w0; its seconds split.  Then a fit
    of the first ``n_path`` subjects from ``.npy`` paths with
    ``temp_dir`` and ``low_ram``, held to the in-memory fit of the same
    subjects, its spills removed by ``clean()``."""
    import os
    import tempfile

    from brainiak_tpu_torch.funcalign import fastsrm, srm

    n_s, n_v, n_t, k = shape or (SRM_SUBJECTS, SRM_VOXELS, SRM_TRS,
                                 SRM_FEATURES)
    X, _, s_true = data or srm_data(n_s, n_v, n_t, k, SEED + 7)
    half = n_t // 2
    imgs = [[np.ascontiguousarray(x[:, :half]),
             np.ascontiguousarray(x[:, half:])] for x in X]
    atlas = np.random.default_rng(SEED + 13).permutation(
        np.arange(n_v) % n_parcels + 1)
    log(f"FastSRM: {n_s} subjects x {n_v} voxels x 2 sessions of {half} "
        f"TRs (phase 14's data), a deterministic atlas of {n_parcels} "
        f"parcels, K={k}, {n_iter} iterations, aggregate mean")
    marks = {"reduce": 0.0, "svd": 0.0, "basis": 0.0}
    real_reduce, real_polar = fastsrm._reduce_one, fastsrm._procrustes
    real_basis = fastsrm.FastSRM._compute_basis
    real_reduced, real_det = fastsrm.FastSRM._fit_reduced, srm._fit_det_srm

    def add(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        marks[name] = marks.get(name, 0.0) + time.perf_counter() - t0
        return out

    def det(*a, **kw):
        marks["w0"] = a[1]
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_det(*a, **kw)
        stop.record()
        torch.cuda.synchronize()
        marks["det_ms"] = start.elapsed_time(stop)
        return out

    fastsrm._reduce_one = lambda *a, **kw: add("reduce", real_reduce, *a,
                                               **kw)
    fastsrm._procrustes = lambda *a, **kw: add("svd", real_polar, *a,
                                               **kw)
    fastsrm.FastSRM._compute_basis = lambda self, *a: add(
        "basis", real_basis, self, *a)
    fastsrm.FastSRM._fit_reduced = lambda self, *a: add(
        "reduced", real_reduced, self, *a)
    srm._fit_det_srm = det
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        model = fastsrm.FastSRM(atlas=atlas, n_components=k, n_iter=n_iter,
                                device=dev).fit(imgs)
        t_fit = time.perf_counter() - t0
    finally:
        fastsrm._reduce_one, fastsrm._procrustes = real_reduce, real_polar
        fastsrm.FastSRM._compute_basis = real_basis
        fastsrm.FastSRM._fit_reduced = real_reduced
        srm._fit_det_srm = real_det
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    shared = model.transform(imgs)
    t_tr = time.perf_counter() - t0
    log(f"  FastSRM fit ({smi}): {t_fit:.3f} s = host reduction "
        f"{marks['reduce']:.3f} + reduced DetSRM {marks['reduced']:.3f} "
        f"(its BCD {marks['det_ms']:.3f} ms by CUDA events) + bases "
        f"{marks['basis']:.3f} (products and upload "
        f"{marks['basis'] - marks['svd']:.3f}, wide SVD "
        f"{marks['svd']:.3f}) + the rest; transform {t_tr:.3f} s; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    cos = principal_cosines(np.concatenate(shared, axis=1), s_true)
    ortho = max(float(np.abs(b @ b.T - np.eye(k)).max())
                for b in model.basis_list)
    # the float64 fit from the same w0: the parcel means in float64
    # (one one-hot product a subject on the card), then the port's
    # reduced DetSRM and bases in float64
    values = np.unique(atlas)
    values = values[values != 0]
    onehot = torch.from_numpy(atlas[:, None] == values[None, :]).to(
        dev, torch.float64)
    onehot /= onehot.sum(dim=0)
    x64 = torch.stack([(torch.from_numpy(x).to(dev, torch.float64).T
                        @ onehot).T for x in X])
    del onehot
    w, shared64, _ = srm._fit_det_srm(
        x64, marks["w0"].to(torch.float64), n_iter)
    s64 = shared64.T.cpu().numpy()
    ref = [real_basis(model, subj, [s64[:half], s64[half:]])
           for subj in imgs]
    del x64, w, shared64
    rb = max(float(np.abs(b - r).max()) for b, r in
             zip(model.basis_list, ref)) / \
        max(float(np.abs(r).max()) for r in ref)
    log(f"  FastSRM: principal cosines to the planted shared response: "
        f"smallest {cos.min():.5f}, median {np.median(cos):.5f}; max|B "
        f"B^T - I| {ortho:.3e}; vs the float64 fit max|dB|/max|B| "
        f"{rb:.3e}")
    if cos.min() <= FASTSRM_COSINE:
        fail(f"FastSRM: smallest principal cosine {cos.min():.4f}")
    if ortho > SRM_ORTHO:
        fail(f"FastSRM: the bases are not orthonormal ({ortho:.3e})")
    if rb > FASTSRM_BASIS_RTOL:
        fail(f"FastSRM: the float32 bases are off the float64 ones "
             f"({rb:.3e})")
    del model, ref
    with tempfile.TemporaryDirectory(prefix="fastsrm_npy_") as root:
        paths = np.empty((n_path, 2), dtype=object)
        for i in range(n_path):
            for j in range(2):
                paths[i, j] = os.path.join(root, f"s{i}_{j}.npy")
                np.save(paths[i, j], imgs[i][j])
        t0 = time.perf_counter()
        spilled = fastsrm.FastSRM(atlas=atlas, n_components=k,
                                  n_iter=n_iter, temp_dir=root,
                                  low_ram=True, device=dev).fit(paths)
        t_path = time.perf_counter() - t0
        memory = {}

        def in_memory():
            memory["fit"] = fastsrm.FastSRM(
                atlas=atlas, n_components=k, n_iter=n_iter,
                device=dev).fit(imgs[:n_path])

        t0 = time.perf_counter()
        n_sync, where = count_syncs(torch, in_memory)
        t_mem = time.perf_counter() - t0
        d = max(float(np.abs(np.load(p) - b).max())
                for p, b in zip(spilled.basis_list,
                                memory["fit"].basis_list))
        spill_dir = spilled.temp_dir
        n_files = len(os.listdir(spill_dir))
        spilled.clean()
        log(f"  FastSRM from .npy paths, {n_path} subjects, temp_dir and "
            f"low_ram: {t_path:.3f} s ({n_files} files spilled); in "
            f"memory {t_mem:.3f} s with {n_sync} host syncs at {where}; "
            f"max|dB| {d:.3e}; spills removed by clean(): "
            f"{not os.path.exists(spill_dir)}")
        if d > FASTSRM_PATH_ATOL or os.path.exists(spill_dir) or \
                n_files != 3 * n_path:
            fail("FastSRM: the .npy-path fit is off the in-memory fit, "
                 "or its spills were not removed")
    torch.cuda.empty_cache()


# -- FCMA on a mesh (phases 20-22) ------------------------------------

MESH_GRAM_RTOL = 1e-5  # of K[0, 0]: the mesh and distla Grams vs meshless
#: the voxel positions of phases 20 and 21, all on the one card
MESH_POSITIONS = 4


def phase_mesh_kernels(torch, dev):
    """K1 at the shapes the mesh paths give it, whole-brain widths: a
    mesh position's slice of the 1,024 block voxels (B=256) against
    the 65,536 voxels (phase 20), the 1,024 block voxels against one
    data2 shard of 16,384 voxels (phase 21), and a rank's half of the
    block voxels (B=512) against the 65,536 voxels (phase 23's two
    ranks); inputs of their own seed."""
    rng = np.random.default_rng(SEED + 15)
    rows = {}
    for name, n_b, n_v in (("fcma_gram_mesh", 256, 65536),
                           ("fcma_gram_distla", 1024, 16384),
                           ("fcma_gram_rank", 512, 65536)):
        data = normalized_epochs(torch, rng, 32, 150, n_v, dev)
        blk = normalized_epochs(torch, rng, 32, 150, n_b, dev)
        rows[name] = check_k1(torch, blk, data, 4, 5)["tc"]
        del blk, data
        torch.cuda.empty_cache()
    return rows


def captured_grams(torch, vs):
    """``vs.run('svm')`` and the shrunk Grams its SMO solved: a copy of
    each batch handed to ``svm_cv_accuracy``, concatenated (voxel
    order where one device solves them all)."""
    from brainiak_tpu_torch.fcma import voxelselector as vmod

    seen, real = [], vmod.svm_cv_accuracy

    def spy(kernels, *args, **kw):
        seen.append(kernels.clone())
        return real(kernels, *args, **kw)

    vmod.svm_cv_accuracy = spy
    try:
        results = vs.run('svm')
    finally:
        vmod.svm_cv_accuracy = real
    return results, torch.cat(seen)


def gram_rel_err(got, want):
    """Largest |got - want| over each voxel's K[0, 0]."""
    return float(((got - want).abs() / want[:, :1, :1].abs()).max())


def check_agree(label, got, want, n_folds, n_epochs):
    """Accuracies equal on at least ``ACC_AGREE`` of the voxels and
    never more than one test sample a fold apart."""
    same = float(np.mean(np.isclose(got, want, rtol=0, atol=1e-6)))
    worst = float(np.max(np.abs(got - want)))
    one_sample = n_folds / n_epochs
    log(f"  {label}: accuracies equal on {same:.4f} of {len(got)} voxels,"
        f" max diff {worst:.4f} (one test sample a fold = "
        f"{one_sample:.4f})")
    if same < ACC_AGREE or worst > one_sample + 1e-6:
        fail(f"{label}: accuracies disagree")


def timed_run(torch, vs):
    """One warm ``run('svm')``: its results, host-clock seconds (ending
    in a synchronize), K1's launches in it and the peak device memory
    over it."""
    from brainiak_tpu_torch.ops import fcma_kernels as fk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    t0 = time.perf_counter()
    results = vs.run('svm')
    torch.cuda.synchronize()
    return (results, time.perf_counter() - t0, fk.launches(),
            torch.cuda.max_memory_allocated() / 2**30)


def run_mesh_selection(torch, vs, accs):
    """Phase 20: ``VoxelSelector(mesh=)`` on phase 3's inputs, a
    4-position voxel mesh of the one card: K1 once a position (256
    block voxels each against the 65,536), one SMO on the one device.
    Its Grams against the meshless run's (bit for bit expected: K1's
    arithmetic a voxel does not depend on the block's width), its
    accuracies against phase 3's."""
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector
    from brainiak_tpu_torch.parallel import make_mesh

    mesh = make_mesh(("voxel",), (MESH_POSITIONS,),
                     devices=["cuda"] * MESH_POSITIONS)
    _, ref_grams = captured_grams(torch, vs)
    mvs = VoxelSelector(vs.labels, 4, vs.num_folds, vs.raw_data,
                        raw_data2=vs.raw_data2, mesh=mesh)
    mvs.run('svm')   # cold: places the stacks on the card once
    results, t_warm, launches, peak = timed_run(torch, mvs)
    got = check_accuracies(results, mvs.num_voxels)
    _, grams = captured_grams(torch, mvs)
    equal = bool(torch.equal(grams, ref_grams))
    rel = gram_rel_err(grams, ref_grams)
    log(f"phase 20, VoxelSelector(mesh=) on {MESH_POSITIONS} positions of "
        f"the card: warm run('svm') {t_warm:.3f} s = "
        f"{mvs.num_voxels / t_warm:.1f} voxels/s, K1 launches "
        f"{launches['fcma_gram']} ({launches['fcma_gram_tc']} tensor-core),"
        f" peak device memory {peak:.2f} GiB; Grams vs the meshless "
        f"run's: " + ("equal bit for bit" if equal else
                      f"max err/K[0,0] {rel:.3e} (rtol {MESH_GRAM_RTOL})"))
    if launches["fcma_gram"] != MESH_POSITIONS or \
            launches["fcma_gram_tc"] != MESH_POSITIONS:
        fail(f"phase 20: {launches['fcma_gram']} K1 launches, not one a "
             f"position ({MESH_POSITIONS}) on the tensor-core kernel")
    if not equal and not rel <= MESH_GRAM_RTOL:
        fail("phase 20: the mesh Grams disagree with the meshless ones")
    if np.array_equal(got, accs):
        log("  accuracies equal phase 3's on every voxel")
    else:
        check_agree("phase 20 vs phase 3", got, accs, vs.num_folds,
                    len(vs.labels))
    del mvs
    torch.cuda.empty_cache()
    return launches["fcma_gram_tc"], ref_grams, got


class _Warnings:
    """The warning messages a logger emits while in a ``with``."""

    def __init__(self, name):
        import logging

        self.logger = logging.getLogger(name)
        self.messages = []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda rec: self.messages.append(
            rec.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def run_distla_selection(torch, vs, accs, ref_grams, host_accs,
                         budget=1 << 30):
    """Phase 21: ``use_distla=True`` on phase 3's inputs: data2 (1.26 GB)
    split into 4 shards of 16,384 voxels on the card, one block of all
    1,024 mask1 voxels (``voxel_unit`` 1,024), K1 once a shard and the
    partial Grams summed.  The Gram against the meshless K1's, the
    accuracies against phase 3's.  Then ``use_distla='auto'`` with a
    budget below data2's bytes must engage, and a host-CV ``run(clf)``
    on 256 voxels degrade to the replicated layout with the warning,
    its accuracies held to phase 3's host-CV branch (``budget``: 1
    GiB, below the 1.26 GB)."""
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector
    from brainiak_tpu_torch.ops import fcma_kernels as fk
    from brainiak_tpu_torch.parallel import make_mesh

    mesh = make_mesh(("voxel",), (MESH_POSITIONS,),
                     devices=["cuda"] * MESH_POSITIONS)
    dvs = VoxelSelector(vs.labels, 4, vs.num_folds, vs.raw_data,
                        raw_data2=vs.raw_data2, voxel_unit=vs.num_voxels,
                        mesh=mesh, use_distla=True)
    dvs.run('svm')   # cold: splits data2 over the positions once
    results, t_warm, launches, peak = timed_run(torch, dvs)
    got = check_accuracies(results, dvs.num_voxels)
    _, grams = captured_grams(torch, dvs)
    rel = gram_rel_err(grams, ref_grams)
    data2_bytes = 4 * len(vs.raw_data2) * vs.raw_data2[0].size
    log(f"phase 21, use_distla=True: data2 {data2_bytes / 1e9:.2f} GB in "
        f"{MESH_POSITIONS} shards of {vs.num_voxels2 // MESH_POSITIONS} "
        f"voxels; warm run('svm') {t_warm:.3f} s = "
        f"{dvs.num_voxels / t_warm:.1f} voxels/s, K1 launches "
        f"{launches['fcma_gram']} ({launches['fcma_gram_tc']} tensor-core),"
        f" peak device memory {peak:.2f} GiB; Gram vs the meshless K1's "
        f"max err/K[0,0] {rel:.3e} (rtol {MESH_GRAM_RTOL})")
    if launches["fcma_gram"] != MESH_POSITIONS or \
            launches["fcma_gram_tc"] != MESH_POSITIONS:
        fail(f"phase 21: {launches['fcma_gram']} K1 launches, not one a "
             f"data2 shard ({MESH_POSITIONS}) on the tensor-core kernel")
    if not rel <= MESH_GRAM_RTOL:
        fail("phase 21: the summed partial Grams disagree with K1's")
    check_agree("phase 21 vs phase 3", got, accs, vs.num_folds,
                len(vs.labels))
    del dvs, grams
    torch.cuda.empty_cache()

    avs = VoxelSelector(vs.labels, 4, vs.num_folds,
                        [m[:, :256] for m in vs.raw_data],
                        raw_data2=vs.raw_data2, mesh=mesh,
                        replicated_budget_bytes=budget)
    if not (avs.use_distla and avs._distla_auto):
        fail(f"phase 21: use_distla='auto' did not engage at a budget of "
             f"{budget} bytes for {data2_bytes} bytes of data2")
    fk.reset_launches()
    with _Warnings("brainiak_tpu_torch.fcma.voxelselector") as warned:
        host = check_accuracies(avs.run(_KernelNearestMean()), 256)
    k3 = fk.launches()
    degraded = any("falling back" in m for m in warned)
    log(f"  use_distla='auto' at a budget of {budget} bytes: engaged; "
        f"host-CV run(clf) on 256 voxels degraded with the warning: "
        f"{degraded}, layout restored after: {avs.use_distla}; K3 "
        f"launches {k3['fcma_corr_normalize']} "
        f"({k3['fcma_corr_normalize_tc']} tensor-core)")
    if not degraded or not avs.use_distla:
        fail("phase 21: the auto-engaged host-CV run did not degrade, "
             "warn and restore")
    check_agree("phase 21 host CV vs phase 3's", host, host_accs,
                vs.num_folds, len(vs.labels))
    del avs
    torch.cuda.empty_cache()
    return launches["fcma_gram_tc"]


def nccl_worker(process_id, num_processes):
    """Phase 22 on one rank of two, its own card: phase 3's inputs made
    anew from their seed, ``VoxelSelector(mesh=)`` on the two ranks'
    voxel mesh, and ring path C's ``isfc(mesh=)`` against its dense
    ``isfc`` on this rank."""
    from brainiak_tpu_torch import set_fp32_defaults

    set_fp32_defaults()
    return mesh_paths_on_ranks()


def mesh_paths_on_ranks():
    """The body of phase 22's worker, which phase 23's runs too: the
    FCMA mesh and the ring ``isfc`` on a voxel mesh of this rank's
    positions and its peer's."""
    import torch

    from brainiak_tpu_torch import isc as tisc
    from brainiak_tpu_torch.fcma import prepare_fcma_data
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector
    from brainiak_tpu_torch.ops.kernels import ring as kr
    from brainiak_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    images, conditions, mask1 = whole_brain_inputs(
        np.random.default_rng(SEED + 1))
    raw1, raw2, labels = prepare_fcma_data(
        images, conditions, mask1, np.ones(mask1.shape, dtype=bool))
    del images
    t_prep = time.perf_counter() - t0
    mesh = make_mesh(("voxel",), (-1,))
    vs = VoxelSelector(labels, 4, 4, raw1, raw_data2=raw2, mesh=mesh)
    vs.run('svm')
    results, t_fcma, launches, _ = timed_run(torch, vs)
    out = {"accs": np.array([a for _, a in sorted(results)]),
           "prep_s": t_prep, "fcma_s": t_fcma,
           "k1": launches["fcma_gram_tc"],
           "card": torch.cuda.current_device()}
    del vs, raw1, raw2
    data = isfc_data(8, 600, 8192)
    kr.reset_launches()
    t0 = time.perf_counter()
    ring = tisc.isfc(data, mesh=mesh)
    out["isfc_s"] = time.perf_counter() - t0
    out["k5"], out["k5_all"], out["k5_split"] = (
        kr.launches("tc"), kr.launches(), kr.launches("split"))
    t0 = time.perf_counter()
    dense = tisc.isfc(data)
    out["dense_s"] = time.perf_counter() - t0
    out["isfc_err"] = max(float(np.max(np.abs(r - d)))
                          for r, d in zip(ring, dense))
    return out


def run_two_ranks(torch, mesh_accs):
    """Phase 22: ``VoxelSelector(mesh=)`` and ``isfc(mesh=)`` on two
    ranks over NCCL, one card each, against phases 20 and C.  It needs
    two cards; on one it says so and returns."""
    import os

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"phase 22, two ranks over NCCL: needs two cards, this "
            f"machine has {n_cards}; not run")
        return
    from brainiak_tpu_torch.parallel.testing import run_distributed

    t0 = time.perf_counter()
    ranks = run_distributed(
        "chip_smoke", "nccl_worker", n_procs=2, device="cuda",
        timeout=900, extra_path=os.path.dirname(os.path.abspath(__file__)))
    log(f"phase 22, two ranks over NCCL: {time.perf_counter() - t0:.1f} s"
        " with the processes' start")
    for pid, r in enumerate(ranks):
        log(f"  rank {pid} (cuda:{r['card']}): warm run('svm') "
            f"{r['fcma_s']:.3f} s, K1 launches {r['k1']}; isfc(mesh=) "
            f"{r['isfc_s']:.3f} s, K5 launches {r['k5']}, max diff vs "
            f"dense {r['isfc_err']:.3e} (atol {ISFC_ATOL})")
        if not np.array_equal(r["accs"], ranks[0]["accs"]):
            fail("phase 22: the ranks return different accuracies")
        if not r["isfc_err"] <= ISFC_ATOL:
            fail("phase 22: the two-rank ring disagrees with the dense isfc")
    check_agree("phase 22 vs phase 20", ranks[0]["accs"], mesh_accs, 4, 32)


# -- phases 23-25: the subject axis and the searchlight across ranks ---

#: two-rank fits against the single-process fits of phases 14 and 17
#: from the same w0, in max|dW| / max|W|, max|dS| / max|S| (R for
#: RSRM) and d(objective) / |objective|.  In float64 the ranks' chunk
#: functions are held to the one-process float64 fit at 1e-10 in all
#: three, which leaves no room for a fault in the collectives; the
#: float32 fits are held to the one-process float32 fits at 1e-3 on W,
#: 1e-5 on the objective and 3e-3 on S or R: SRM's S carries the
#: cancellation in I - rho0 (inv(Sigma_s) + rho0 I)^-1, and the
#: two-rank sum of two partials moves it by 1.362e-3 of max|S| on an
#: H100 (each float32 fit 7.5e-4 of max|S| off float64), where the
#: float64 fits agree to 1.9e-12
TWO_RANK_F64_RTOL = 1e-10
TWO_RANK_RTOLS = (1e-3, 3e-3, 1e-5)
SL_SHAPE, SL_SUBJECTS, SL_TRS = (64, 64, 36), 8, 150
SL_VOXELS = 56240     # the ellipsoid mask's voxels
SL_RAD, SL_CENTRES = 3, 55808   # Ball(3): 123 voxels a neighbourhood
SL_BATCHES = (256, 1024)
SL_SAMPLED, SL_F64_ATOL = 2000, 1e-4   # centres held to float64 NumPy
SL_MESH_ATOL = 1e-6   # the 4-position mesh and two ranks vs meshless
MVPA_DIM, MVPA_TRS, MVPA_FOLDS, MVPA_POOL = 16, 120, 4, 4
MVPA_TOP = 5          # voxels that must lie in the planted region
#: K5's launches on a rank of phase 23: 8 rings (one a subject) of 2
#: steps each, and the pre-pass splits of each ring's two operands
TWO_RANK_K5 = 16


class _CollectiveBytes:
    """While installed, counts this rank's calls of the collectives the
    port makes (``torch.distributed``'s ``all_reduce``, ``all_gather``
    and ``batch_isend_irecv``), the bytes it hands to them (the
    tensors it sends) and the bytes they return to it (the buffers they
    fill: an ``all_gather`` fills one of the sent size from each rank,
    its own included)."""

    def __init__(self, torch):
        self.dist = torch.distributed
        self.calls = self.sent = self.received = 0

    @staticmethod
    def _bytes(t):
        return t.numel() * t.element_size()

    def __enter__(self):
        dist = self.dist
        self.real = {n: getattr(dist, n) for n in
                     ("all_reduce", "all_gather", "batch_isend_irecv")}

        def all_reduce(t, *a, **k):
            self.calls += 1
            self.sent += self._bytes(t)
            self.received += self._bytes(t)
            return self.real["all_reduce"](t, *a, **k)

        def all_gather(parts, t, *a, **k):
            self.calls += 1
            self.sent += self._bytes(t)
            self.received += sum(self._bytes(p) for p in parts)
            return self.real["all_gather"](parts, t, *a, **k)

        def batch_isend_irecv(ops):
            self.calls += 1
            for op in ops:
                if op.op is dist.isend:
                    self.sent += self._bytes(op.tensor)
                else:
                    self.received += self._bytes(op.tensor)
            return self.real["batch_isend_irecv"](ops)

        dist.all_reduce, dist.all_gather = all_reduce, all_gather
        dist.batch_isend_irecv = batch_isend_irecv
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.dist, n, fn)

    def line(self):
        return (f"{self.calls} collective calls, {self.sent / 1e6:.3f} MB "
                f"sent, {self.received / 1e6:.3f} MB received")


def _digest(a):
    import hashlib
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def float64_fit(torch, kind, data, mesh):
    """The float64 fit of ``kind``'s chunk functions across the ranks,
    on this rank's subjects of ``data`` laid out on the subject mesh,
    from the estimator's w0 in float64: what phases 14 and 17 hold
    their float32 fits to in one process.  Returns (W whole, S or R,
    objective) on the host, on every rank."""
    from brainiak_tpu_torch.funcalign import rsrm, srm
    from brainiak_tpu_torch.parallel.mesh import (fetch_rows, local_rows,
                                                  shard_along)

    dev = mesh.local_devices()[0]
    stacked, counts, _, trace = srm._stack_and_pad(
        data, np.float64, demean=kind == "SRM")
    x = shard_along(stacked, mesh, "subject", 0)
    n_s, v_pad, _ = stacked.shape
    w0 = local_rows(x, srm._init_w(
        0, v_pad, n_s, SRM_FEATURES,
        torch.from_numpy(counts.astype(np.float32)).to(dev),
        dtype=torch.float32, device=dev)).to(torch.float64)
    if kind == "SRM":
        w, _, _, shared, obj = srm._fit_prob_srm(
            x, torch.from_numpy(trace).to(dev),
            torch.from_numpy(counts.astype(np.float64)).to(dev), w0,
            SRM_ITERS, mesh=mesh)
    elif kind == "DetSRM":
        w, shared, obj = srm._fit_det_srm(x, w0, SRM_ITERS, mesh=mesh)
    else:
        w, _, shared, obj = rsrm._fit_rsrm(x, w0, RSRM_GAMMA, SRM_ITERS,
                                           mesh=mesh)
    return fetch_rows(x, w), shared.cpu().numpy(), float(obj)


def two_rank_fits(torch, mesh):
    """Phase 23's SRM, DetSRM and RSRM on this rank's half of phase
    14's subjects (phase 17's planted data for RSRM), each in float32
    through the estimator and in float64 through its chunk functions:
    the float32 fit's seconds and collectives, and of each fit its W,
    S or R and objective (W and S as digests alone on rank 1)."""
    from brainiak_tpu_torch.funcalign import rsrm, srm

    t0 = time.perf_counter()
    X, _, _ = srm_data(SRM_SUBJECTS, SRM_VOXELS, SRM_TRS, SRM_FEATURES,
                       SEED + 7)
    planted, _ = plant_sparse(X, SEED + 10)
    me = torch.distributed.get_rank()
    fits = {"data_s": time.perf_counter() - t0}
    for kind, data in (("SRM", X), ("DetSRM", X), ("RSRM", planted)):
        kw = dict(n_iter=SRM_ITERS, features=SRM_FEATURES, mesh=mesh)
        model = rsrm.RSRM(gamma=RSRM_GAMMA, **kw) if kind == "RSRM" \
            else getattr(srm, kind)(**kw)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        with _CollectiveBytes(torch) as moved:
            t0 = time.perf_counter()
            model.fit(data)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        w = np.stack(model.w_)
        shared = model.r_ if kind == "RSRM" else model.s_
        obj = model.logprob_ if kind == "SRM" else model.objective_
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        w64, s64, obj64 = float64_fit(torch, kind, data, mesh)
        torch.cuda.synchronize()
        secs64 = time.perf_counter() - t0
        torch.cuda.empty_cache()
        fits[kind] = {"secs": secs, "moved": moved.line(),
                      "secs64": secs64,
                      "digests": [_digest(a) for a in (w, shared, w64,
                                                       s64)],
                      "objectives": (obj, obj64),
                      "fits": ((w, shared), (w64, s64)) if me == 0
                      else None}
    return fits


def gloo_worker(process_id, num_processes):
    """Phase 23 on one rank of two, both on the one card over gloo: the
    subject-axis fits across the ranks, then phase 22's body (the FCMA
    mesh and the ring ``isfc``), with this rank's collectives; then
    phase 30's HTFA on a subject mesh of the ranks."""
    import torch

    from brainiak_tpu_torch import set_fp32_defaults
    from brainiak_tpu_torch.parallel import make_mesh

    set_fp32_defaults()
    out = {"fits": two_rank_fits(torch, make_mesh(("subject",), (-1,)))}
    torch.cuda.empty_cache()
    with _CollectiveBytes(torch) as moved:
        out.update(mesh_paths_on_ranks())
    out["moved"] = moved.line()
    torch.cuda.empty_cache()
    with _CollectiveBytes(torch) as moved:
        out["htfa"] = htfa_on_ranks(torch)
    out["htfa"]["moved"] = moved.line()
    return out


def rel_max(got, want):
    """max|got - want| / max|want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def run_gloo_ranks(torch, smi, single, mesh_accs, rows):
    """Phase 23: two ranks on the one card over gloo
    (``run_distributed(..., device="cuda", backend="gloo")``: both on
    ``cuda:0``, every collective staged through the host).  SRM, DetSRM
    and RSRM at phase 14's shape, 10 subjects a rank, each rank's fits
    bit for bit the other's; the float64 fits within
    ``TWO_RANK_F64_RTOL`` of the one-process float64 fits, the float32
    fits within ``TWO_RANK_RTOLS`` of the one-process float32 fits
    (``single``: phases 14 and 17's, from the same w0).  Then phase
    22's FCMA mesh and ring ``isfc(mesh=)``, held to phase 20's
    accuracies (``mesh_accs``) and to the dense ``isfc``, K1 once a
    rank and K5 ``TWO_RANK_K5`` times.  Sets the launches of the rows
    of K1 and K5 at phase 23's shapes.  Returns each rank's HTFA fit
    (``htfa_on_ranks``), which phase 30 holds to one process."""
    import os

    from brainiak_tpu_torch.parallel.testing import run_distributed

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_distributed(
        "chip_smoke", "gloo_worker", n_procs=2, device="cuda",
        backend="gloo", timeout=600,
        extra_path=os.path.dirname(os.path.abspath(__file__)))
    log(f"phase 23, two ranks on the one card over gloo ({smi}): "
        f"{time.perf_counter() - t0:.1f} s with the processes' start")
    data_s = ", ".join(f"{r['fits']['data_s']:.1f}" for r in ranks)
    log(f"  the ranks' SRM data made in {data_s} s")
    for kind in ("SRM", "DetSRM", "RSRM"):
        got = [r["fits"][kind] for r in ranks]
        for pid, f in enumerate(got):
            log(f"  rank {pid} {kind}: float32 fit {f['secs']:.3f} s, "
                f"{f['moved']}; float64 fit {f['secs64']:.3f} s")
        if any(f["digests"] != got[0]["digests"] or
               f["objectives"] != got[0]["objectives"] for f in got):
            fail(f"phase 23: the ranks' {kind} fits differ")
        name = "R" if kind == "RSRM" else "S"
        errs = {}
        for prec, (w, shared), obj, (w_ref, s_ref, obj_ref) in zip(
                ("float32", "float64"), got[0]["fits"],
                got[0]["objectives"], (single[kind], single[kind + "_f64"])):
            errs[prec] = (rel_max(w, w_ref), rel_max(shared, s_ref),
                          abs(obj - obj_ref) / abs(obj_ref))
            log(f"  {kind} {prec} on two ranks vs one process: "
                f"max|dW|/max|W| {errs[prec][0]:.3e}, max|d{name}|/max|"
                f"{name}| {errs[prec][1]:.3e}, dobj/|obj| "
                f"{errs[prec][2]:.3e}; bit for bit on both ranks")
        w64, s64, _ = single[kind + "_f64"]
        for who, (w32, s32) in (("one-process", single[kind][:2]),
                                ("two-rank", got[0]["fits"][0])):
            log(f"  the {who} {kind} float32 fit vs the one-process "
                f"float64 fit: max|dW|/max|W| {rel_max(w32, w64):.3e}, "
                f"max|d{name}|/max|{name}| {rel_max(s32, s64):.3e} "
                "(float32's own rounding)")
        log(f"  bounds: float64 {TWO_RANK_F64_RTOL}, float32 "
            f"{TWO_RANK_RTOLS}")
        if not max(errs["float64"]) <= TWO_RANK_F64_RTOL:
            fail(f"phase 23: the two-rank float64 {kind} fit is off the "
                 "one-process float64 fit")
        if not all(e <= t for e, t in zip(errs["float32"], TWO_RANK_RTOLS)):
            fail(f"phase 23: the two-rank {kind} fit is off the "
                 "single-process fit")
    for pid, r in enumerate(ranks):
        log(f"  rank {pid} (cuda:{r['card']}): FCMA inputs and prepare "
            f"{r['prep_s']:.1f} s, warm run('svm') {r['fcma_s']:.3f} s, "
            f"K1 launches {r['k1']}; isfc(mesh=) {r['isfc_s']:.3f} s, K5 "
            f"launches {r['k5_all']} ({r['k5']} tensor-core, "
            f"{r['k5_split']} pre-pass splits), dense isfc "
            f"{r['dense_s']:.3f} s, max diff vs dense {r['isfc_err']:.3e} "
            f"(atol {ISFC_ATOL}); {r['moved']}")
        if not np.array_equal(r["accs"], ranks[0]["accs"]):
            fail("phase 23: the ranks return different accuracies")
        if not r["isfc_err"] <= ISFC_ATOL:
            fail("phase 23: the two-rank ring disagrees with the dense isfc")
        if r["k1"] != 1 or not (r["k5"] == r["k5_all"] == r["k5_split"]
                                == TWO_RANK_K5):
            fail(f"phase 23: rank {pid} ran K1 {r['k1']} times (not once) "
                 f"and K5 {r['k5_all']} times, {r['k5']} tensor-core, "
                 f"with {r['k5_split']} splits (not {TWO_RANK_K5} each)")
    check_agree("phase 23 vs phase 20", ranks[0]["accs"], mesh_accs, 4, 32)
    rows["fcma_gram_rank"]["launches"] = sum(r["k1"] for r in ranks)
    rows["ring_mma_v4096"]["launches"] = sum(r["k5"] for r in ranks)
    for pid, r in enumerate(ranks):
        log(f"  rank {pid} HTFA ({HTFA_RANK_SUBJECTS} subjects on a subject "
            f"mesh of the ranks): {r['htfa']['secs']:.3f} s; "
            f"{r['htfa']['moved']} (held to one process in phase 30)")
    return [r["htfa"] for r in ranks]


def sl_volume():
    """Phase 24's data from its seed: 8 subjects [64, 64, 36, 150]
    float32, one shared signal plus noise each, and the ellipsoid brain
    mask (semi-axes 0.45 of each edge: 56,240 voxels)."""
    rng = np.random.default_rng(SEED + 20)
    signal = rng.standard_normal(SL_SHAPE + (SL_TRS,), dtype=np.float32)
    subjects = []
    for _ in range(SL_SUBJECTS):
        x = rng.standard_normal(SL_SHAPE + (SL_TRS,), dtype=np.float32)
        x += signal
        subjects.append(x)
    grid = np.meshgrid(*[np.arange(n) for n in SL_SHAPE], indexing="ij")
    mask = sum(((g - (n - 1) / 2) / (0.45 * n)) ** 2
               for g, n in zip(grid, SL_SHAPE)) <= 1
    return subjects, mask


def rsa_voxel_fn(patches, mask_patch, rad, bcast):
    """The RSA statistic of ``benchmarks/run_baselines.py:142-155`` in
    torch: the correlation between subject 0's neighbourhood contrast
    (mean of the first half of the TRs less the second's) and the mean
    contrast of the other subjects, over the valid voxels."""
    import torch

    half = patches.shape[2] // 2
    d = patches[:, :, :half].mean(dim=2) - patches[:, :, half:].mean(dim=2)
    zero = torch.zeros_like(d[0])
    d0 = torch.where(mask_patch, d[0], zero)
    rest = torch.where(mask_patch, d[1:].mean(dim=0), zero)
    num = torch.sum(d0 * rest)
    den = torch.sqrt(torch.sum(d0 ** 2) * torch.sum(rest ** 2)) + 1e-12
    return num / den


def rsa_float64(subjects, mask, shape_mask, centres):
    """``rsa_voxel_fn`` in float64 NumPy at ``centres``."""
    rad = shape_mask.shape[0] // 2
    half = subjects[0].shape[3] // 2
    out = np.empty(len(centres))
    for n, (i, j, k) in enumerate(centres):
        sl = np.s_[i - rad:i + rad + 1, j - rad:j + rad + 1,
                   k - rad:k + rad + 1]
        valid = (mask[sl] & shape_mask)[shape_mask]
        d = np.stack([s[sl][shape_mask].astype(np.float64)
                      for s in subjects])
        d = d[:, :, :half].mean(axis=2) - d[:, :, half:].mean(axis=2)
        d0 = np.where(valid, d[0], 0.0)
        rest = np.where(valid, d[1:].mean(axis=0), 0.0)
        out[n] = np.sum(d0 * rest) / (
            np.sqrt(np.sum(d0 ** 2) * np.sum(rest ** 2)) + 1e-12)
    return out


def sweep_worker(process_id, num_processes):
    """Phase 24's sweep on one rank of two over gloo, both on the one
    card: the volume from its seed, the centres split over the ranks'
    voxel mesh; every rank returns the whole volume."""
    import torch

    from brainiak_tpu_torch import set_fp32_defaults
    from brainiak_tpu_torch.parallel import make_mesh
    from brainiak_tpu_torch.searchlight import Ball, Searchlight

    set_fp32_defaults()
    subjects, mask = sl_volume()
    sl = Searchlight(sl_rad=SL_RAD, shape=Ball,
                     mesh=make_mesh(("voxel",), (-1,)))
    sl.distribute(subjects, mask)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    vol = sl.run_searchlight_jax(rsa_voxel_fn, batch_size=SL_BATCHES[-1])
    return vol, time.perf_counter() - t0


def run_searchlight_phase(torch, smi, dev="cuda"):
    """Phase 24: the searchlight's traced tier at whole-brain width (8
    subjects on a 64 x 64 x 36 grid, 150 TRs, float32, 0.71 GB on the
    card; Ball(3), 55,808 centres, the RSA statistic), at batch sizes
    256 and 1024: warm centres/s, the launches and device time of a
    batch, peak memory; 2,000 seeded centres against float64 NumPy; a
    4-position mesh of the card and two ranks over gloo against the
    meshless volume."""
    import os

    from brainiak_tpu_torch.parallel import make_mesh
    from brainiak_tpu_torch.parallel.testing import run_distributed
    from brainiak_tpu_torch.searchlight import Ball, Searchlight

    t0 = time.perf_counter()
    subjects, mask = sl_volume()
    t_data = time.perf_counter() - t0
    sl = Searchlight(sl_rad=SL_RAD, shape=Ball, device=dev)
    sl.distribute(subjects, mask)
    centres = sl._centers()
    n_vox, n_p = int(mask.sum()), int(sl.shape.sum())
    log(f"phase 24, searchlight: {SL_SUBJECTS} subjects x {SL_SHAPE} x "
        f"{SL_TRS} TRs, mask {n_vox} voxels, Ball({SL_RAD}) of {n_p} "
        f"voxels, {len(centres)} centres (data made in {t_data:.2f} s)")
    if n_vox != SL_VOXELS or len(centres) != SL_CENTRES:
        fail("phase 24: the mask or the centres are not the whole brain's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sl.run_searchlight_jax(rsa_voxel_fn, batch_size=SL_BATCHES[0])
    log(f"  cold sweep (upload and index included) "
        f"{time.perf_counter() - t0:.3f} s")
    vols = {}
    state = sl._cache
    key = next(iter(state["flat"]))
    for bs in SL_BATCHES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vols[bs] = sl.run_searchlight_jax(rsa_voxel_fn, batch_size=bs)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_batches = -(-len(centres) // bs)
        # the whole warm sweep under the profiler, the card idle at
        # its start; then one batch by CUDA events
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            sl.run_searchlight_jax(rsa_voxel_fn, batch_size=bs)
            torch.cuda.synchronize()
        host, device = launch_counts(torch, prof)
        busy = sum(us for _, (us, _) in device_events(torch, prof)) / 1e3
        one_ms = cuda_ms(torch, lambda: sl._sweep(
            state["flat"][key], state["mflat"][key], state["idx"][0][:bs],
            rsa_voxel_fn, bs), 5)
        per_batch = (f"{busy / n_batches:.3f} ms device busy a batch "
                     f"({device} device kernels seen)" if device else
                     "device busy not measured (the profile recorded no "
                     "device kernel)")
        log(f"  batch {bs} ({smi}): warm sweep {secs:.3f} s, "
            f"{len(centres) / secs:.1f} centres/s, {n_batches} batches; "
            f"profiled sweep: {host / n_batches:.1f} kernel launches a "
            f"batch, {per_batch}; one batch by CUDA events {one_ms:.3f} "
            f"ms; peak device memory {peak:.2f} GiB (a batch gathers "
            f"{SL_SUBJECTS * bs * n_p * SL_TRS * 4 / 1e9:.2f} GB)")
    got = vols[SL_BATCHES[0]]
    finite = np.isfinite(got)
    if got.shape != SL_SHAPE or got.dtype != np.float32 or \
            int(finite.sum()) != len(centres) or \
            not np.all(np.abs(got[finite]) <= 1 + 1e-6):
        fail(f"phase 24: the volume is not {len(centres)} finite "
             f"correlations ({int(finite.sum())})")
    batch_diff = float(np.nanmax(np.abs(vols[SL_BATCHES[1]] - got)))
    c = centres[np.random.default_rng(SEED + 21).choice(
        len(centres), SL_SAMPLED, replace=False)]
    want = rsa_float64(subjects, mask, sl.shape, c)
    f64_err = float(np.max(np.abs(got[c[:, 0], c[:, 1], c[:, 2]] - want)))
    log(f"  batch {SL_BATCHES[1]} vs {SL_BATCHES[0]} max diff "
        f"{batch_diff:.3e}; {SL_SAMPLED} centres vs float64 NumPy max "
        f"diff {f64_err:.3e} (atol {SL_F64_ATOL}); mean statistic "
        f"{float(np.nanmean(got)):.4f}")
    if not f64_err <= SL_F64_ATOL:
        fail("phase 24: the sweep disagrees with float64")
    del sl, vols, state
    torch.cuda.empty_cache()

    mesh = make_mesh(("voxel",), (4,), devices=[dev] * 4)
    slm = Searchlight(sl_rad=SL_RAD, shape=Ball, mesh=mesh)
    slm.distribute(subjects, mask)
    slm.run_searchlight_jax(rsa_voxel_fn, batch_size=SL_BATCHES[-1])
    t0 = time.perf_counter()
    on_mesh = slm.run_searchlight_jax(rsa_voxel_fn,
                                      batch_size=SL_BATCHES[-1])
    t_mesh = time.perf_counter() - t0
    mesh_err = float(np.nanmax(np.abs(on_mesh - got)))
    log(f"  4-position mesh of the card: warm {t_mesh:.3f} s, max diff "
        f"vs meshless {mesh_err:.3e} (atol {SL_MESH_ATOL})")
    if not (mesh_err <= SL_MESH_ATOL and
            np.array_equal(np.isnan(on_mesh), np.isnan(got))):
        fail("phase 24: the mesh sweep disagrees with the meshless one")
    del slm, on_mesh, subjects
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_distributed(
        "chip_smoke", "sweep_worker", n_procs=2, device=dev,
        backend="gloo", timeout=300,
        extra_path=os.path.dirname(os.path.abspath(__file__)))
    errs = [float(np.nanmax(np.abs(v - got))) for v, _ in ranks]
    log(f"  two ranks over gloo: {time.perf_counter() - t0:.1f} s with the "
        f"processes' start, cold sweeps "
        f"{', '.join(f'{t:.3f}' for _, t in ranks)} s, max diff vs "
        f"meshless {max(errs):.3e} (atol {SL_MESH_ATOL})")
    if not (max(errs) <= SL_MESH_ATOL and
            all(np.array_equal(np.isnan(v), np.isnan(got))
                for v, _ in ranks)):
        fail("phase 24: the two-rank sweep disagrees with the meshless one")


class _NearestMean:
    """A classifier on raw features with the scikit-learn
    fit/predict/score interface: the class whose training mean is
    nearest (Euclidean)."""

    def fit(self, x, y):
        self.classes_ = np.unique(y)
        self.means_ = np.stack([x[np.asarray(y) == c].mean(axis=0)
                                for c in self.classes_])
        return self

    def predict(self, x):
        d = ((x[:, None, :] - self.means_[None]) ** 2).sum(axis=2)
        return self.classes_[np.argmin(d, axis=1)]

    def score(self, x, y):
        return float(np.mean(self.predict(x) == np.asarray(y)))


def mvpa_data():
    """Phase 25's volume, the layout of
    ``examples/searchlight_decoding.py:31-46``: uniform noise [16, 16,
    16, 120], random labels, a Gaussian kernel of edge 5 times the
    labels planted at the centre, a ball mask of radius 0.45 of the
    edge.  Returns (data, labels, mask, planted point)."""
    rng = np.random.RandomState(SEED + 22)
    dim, point, kd = MVPA_DIM, (MVPA_DIM // 2,) * 3, 2
    data = rng.random_sample((dim,) * 3 + (MVPA_TRS,)).astype(np.float32)
    labels = rng.choice([0.0, 1.0], (MVPA_TRS,))
    grid = np.mgrid[-kd:kd + 1, -kd:kd + 1, -kd:kd + 1]
    kernel = np.exp(-(grid ** 2).sum(0).astype(np.float32))
    data[tuple(slice(p - kd, p + kd + 1) for p in point)] += \
        np.multiply.outer(kernel, labels).astype(np.float32)
    xx, yy, zz = np.mgrid[:dim, :dim, :dim]
    c = (dim - 1) / 2.0
    mask = np.sqrt((xx - c) ** 2 + (yy - c) ** 2 + (zz - c) ** 2) \
        < dim * 0.45
    return data, labels, mask, point


def run_mvpa_phase(torch, smi):
    """Phase 25: ``MVPAVoxelSelector`` on the host tier (Ball(1), 4
    folds, ``_NearestMean``), serially and with a ``Pool`` of 4 forked
    after CUDA is initialised here (the children touch no CUDA): equal
    volumes and rankings, and the top voxels in the planted region."""
    from brainiak_tpu_torch.fcma.mvpa_voxelselector import \
        MVPAVoxelSelector
    from brainiak_tpu_torch.searchlight import Ball, Searchlight

    if not torch.cuda.is_initialized():
        fail("phase 25: CUDA is not initialised before the pool forks")
    data, labels, mask, point = mvpa_data()
    vols, ranked = {}, {}
    for pool in (1, MVPA_POOL):
        sel = MVPAVoxelSelector(data, mask, labels, MVPA_FOLDS,
                                Searchlight(sl_rad=1, shape=Ball,
                                            pool_size=pool))
        t0 = time.perf_counter()
        vols[pool], ranked[pool] = sel.run(_NearestMean())
        log(f"phase 25, MVPAVoxelSelector, pool_size {pool} ({smi}): "
            f"{int(mask.sum())} voxels in {time.perf_counter() - t0:.3f} s")
    same = all((a is None and b is None) or a == b for a, b in
               zip(vols[1].ravel(), vols[MVPA_POOL].ravel()))
    coords = np.argwhere(mask)
    top = [coords[v] for v, _ in ranked[1][:MVPA_TOP]]
    inside = [bool(np.all(np.abs(t - point) <= 2)) for t in top]
    log(f"  serial and pool volumes equal: {same}; top {MVPA_TOP} voxels "
        f"{[tuple(int(i) for i in t) for t in top]}, accuracies "
        f"{[round(float(a), 4) for _, a in ranked[1][:MVPA_TOP]]}, in the "
        f"planted region (within 2 of {point}): {inside}; median accuracy "
        f"{float(np.median([a for _, a in ranked[1]])):.4f}")
    if not same or ranked[1] != ranked[MVPA_POOL]:
        fail("phase 25: the pool's volume differs from the serial one")
    if not all(inside):
        fail("phase 25: the top voxels are not in the planted region")


# phase 27: the resampling nulls at whole brain, the layout of
# benchmarks/run_baselines.py:103-110 at 65,536 voxels
ST_SUBJECTS, ST_TRS, ST_VOXELS = 20, 300, 65536
ST_SAMPLED = 2000       # voxels held to float64 NumPy
ST_ISC_REF = 2000       # ISC-input resamples held to float64 NumPy
ST_SHIFT_ATOL = 1e-5    # the shift nulls against float64 NumPy
ST_MEAN_ATOL = 1e-12    # float64 'mean' nulls against float64 NumPy
ST_P_AGREE, ST_P_COUNTS = 0.99, 2
# phase 28: event segmentation, benchmarks/run_baselines.py:85-100
ES_TIERS = (("full tier", 100, 500, 40), ("movie", 1000, 1976, 50))
ES_LL_RTOL = 1e-4       # float32 ll_ against a float64 fit on the card
ES_F64_STEPS = 30       # annealing steps of the float64 fits


def stats_data(torch, dev):
    """Phase 27's [T, V, S] float32 data from its seed, drawn on
    ``dev`` and fetched: one shared signal, scaled a voxel by an
    amplitude drawn in [0, 0.4), plus independent noise a subject (so
    the voxels' p-values spread)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 27)
    amp = torch.rand(ST_VOXELS, generator=g, device=dev) * 0.4
    signal = torch.randn((ST_TRS, ST_VOXELS), generator=g,
                         device=dev) * amp
    noise = torch.randn((ST_TRS, ST_VOXELS, ST_SUBJECTS), generator=g,
                        device=dev)
    return (signal[..., None] + noise).cpu().numpy()


def isc_nulls_float64(family, iscs, xs, group=None, statistic="median"):
    """The ISC-input nulls of descriptors ``xs`` over an [S, V] float64
    stack, in NumPy (leave-one-out): [n, V]."""
    summary = np.median if statistic == "median" else \
        (lambda x, axis: np.tanh(np.mean(np.arctanh(x), axis=axis)))
    if family == "subject_bootstrap":
        return summary(iscs[xs], axis=1)
    if family == "sign_flip":
        return summary(xs[:, :, None] * iscs[None], axis=1)
    labels = np.unique(group)
    out = []
    for perm in xs:
        sel = group[perm]
        out.append(np.median(iscs[sel == labels[0]], axis=0)
                   - np.median(iscs[sel == labels[1]], axis=0))
    return np.stack(out)


def shift_nulls_float64(family, data, xs):
    """The leave-one-out shift nulls (median) of descriptors ``xs``
    over [T, V, S] data, in float64 NumPy, each shifted subject against
    the unshifted others' mean, by the spectrum: a circular shift's
    correlation numerators for every shift at once are the
    cross-correlation ``irfft(conj(X) Y)``, and a phase rotation's is
    ``(2 Re sum_f rot_f X_f conj(Y_f) + the Nyquist term) / T``
    (Parseval), the power, hence the denominator, unchanged.  [n, V]."""
    x = data.astype(np.float64)
    n_trs, _, n_subj = x.shape
    others = (x.sum(axis=2, keepdims=True) - x) / (n_subj - 1)
    xd = x - x.mean(axis=0)
    yd = others - others.mean(axis=0)
    den = np.sqrt((xd ** 2).sum(axis=0) * (yd ** 2).sum(axis=0))  # [V, S]
    xf, yf = np.fft.rfft(xd, axis=0), np.fft.rfft(yd, axis=0)
    r = np.empty((len(xs), n_subj, x.shape[1]))
    if family == "circular_timeshift":
        cc = np.fft.irfft(np.conj(xf) * yf, n=n_trs, axis=0)   # [T, V, S]
        for s in range(n_subj):
            r[:, s] = cc[xs[:, s], :, s] / den[:, s]
    else:
        n_pos = xs.shape[1]
        q = xf * np.conj(yf)
        rot = np.exp(1j * xs[:, :, 0, :].astype(np.float64))  # [n, P, S]
        nyq = q[n_pos + 1].real if n_trs % 2 == 0 else 0.0
        for s in range(n_subj):
            num = 2 * (rot[:, :, s] @ q[1:n_pos + 1, :, s]).real
            num = num + (nyq[:, s] if n_trs % 2 == 0 else 0.0)
            r[:, s] = num / n_trs / den[:, s]
    return np.median(r, axis=1)


def stats_probe(torch, engine, x, family, n, kwargs):
    """Kernel launches and host syncs of one engine run of ``n``
    resamples (the counted path), under ``torch.profiler`` and the
    sync debug mode."""
    prof_box = {}

    def run():
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            engine.run(x, family, n, **kwargs)
            torch.cuda.synchronize()
        prof_box["prof"] = prof

    syncs, where = count_syncs(torch, run)
    return launch_counts(torch, prof_box["prof"])[0], syncs, where


def run_stats_phase(torch, smi, dev="cuda"):
    """Phase 27: the four ``*_isc`` nulls at whole brain (20 subjects x
    300 TRs x 65,536 voxels, float32): bootstrap (10,000), sign flip
    (10,000), two groups of 10 (5,000), circular time shift and phase
    randomization (1,000 each), each materialized and counted; warm
    resamples/s, launches and syncs a chunk, peak memory; 2,000 seeded
    voxels against float64 NumPy on the same descriptors; the counted
    p-map against the materialized one; a preempted bootstrap resumed
    bit for bit."""
    import os
    import tempfile

    from brainiak_tpu_torch import isc as tisc
    from brainiak_tpu_torch.resilience import faults
    from brainiak_tpu_torch.stats import engine as eng
    from brainiak_tpu_torch.stats import surrogates as sur

    t0 = time.perf_counter()
    data = stats_data(torch, dev)
    t_data = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iscs = tisc.isc(data, device=dev)
    t_isc = time.perf_counter() - t0
    log(f"phase 27, resampling nulls ({smi}): {ST_SUBJECTS} subjects x "
        f"{ST_TRS} TRs x {ST_VOXELS} voxels float32 ({data.nbytes / 1e9:.2f}"
        f" GB, made in {t_data:.1f} s); isc (leave-one-out) {t_isc:.3f} s")
    vox = np.sort(np.random.default_rng(SEED + 28).choice(
        ST_VOXELS, ST_SAMPLED, replace=False))
    group = np.array([0] * 10 + [1] * 10)
    runs = (
        ("bootstrap_isc", "subject_bootstrap", 10000, iscs,
         lambda rd: tisc.bootstrap_isc(iscs, n_bootstraps=10000,
                                       random_state=SEED + 1,
                                       return_distribution=rd,
                                       device=dev), {}),
        ("permutation_isc, sign flip", "sign_flip", 10000, iscs,
         lambda rd: tisc.permutation_isc(iscs, n_permutations=10000,
                                         random_state=SEED + 2,
                                         return_distribution=rd,
                                         device=dev), {}),
        ("permutation_isc, two groups of 10", "group_shuffle", 5000, iscs,
         lambda rd: tisc.permutation_isc(iscs, group_assignment=group,
                                         n_permutations=5000,
                                         random_state=SEED + 3,
                                         return_distribution=rd,
                                         device=dev),
         {"group_assignment": group}),
        ("timeshift_isc", "circular_timeshift", 1000, data,
         lambda rd: tisc.timeshift_isc(data, n_shifts=1000,
                                       random_state=SEED + 4,
                                       return_distribution=rd,
                                       device=dev), {}),
        ("phaseshift_isc", "phase_randomize", 1000, data,
         lambda rd: tisc.phaseshift_isc(data, n_shifts=1000,
                                        random_state=SEED + 5,
                                        return_distribution=rd,
                                        device=dev), {}),
    )
    results = {}
    for k, (label, family, n, x, call, extra) in enumerate(runs):
        shift = family not in sur.ISC_INPUT_FAMILIES
        # the default lanes: a leave-one-out shift lane holds [V, S]
        batch = eng.default_null_batch(
            ST_TRS * ST_VOXELS * ST_SUBJECTS if shift else ST_VOXELS)
        chunk = eng._chunk_length(ST_VOXELS, batch,
                                  eng.stats_budget_bytes())
        # warm-up and the counts: one chunk, then two (the setup
        # cancels); a shift family's probe chunks hold two lane groups
        probe = 2 * batch if shift else chunk
        engine = eng.NullEngine(null_batch_size=batch, device=dev,
                                budget_bytes=16 * ST_VOXELS * probe)
        kw = dict(statistic="median", seed=SEED + 1 + k,
                  observed=np.zeros(ST_VOXELS), **extra)
        launches, syncs = [], []
        t_probe = time.perf_counter()
        for m in (1, 2):
            a, b, where = stats_probe(torch, engine, x, family,
                                      m * probe, kw)
            launches.append(a)
            syncs.append(b)
        t_probe = time.perf_counter() - t_probe
        out = {}
        for rd in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out[rd] = call(rd)
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  {label}, return_distribution={rd} ({smi}): {n} "
                f"resamples in {secs:.3f} s, {n / secs:.1f} resamples/s "
                f"warm, peak device memory {peak:.2f} GiB, "
                f"null_batch_size {batch}")
        log(f"    a chunk of {probe} resamples ({probe // batch} lane "
            f"groups; the runs above take {chunk} a chunk): "
            f"{launches[1] - launches[0]} kernel launches, "
            f"{syncs[1] - syncs[0]} host syncs (a one-chunk run, the "
            f"setup included: {launches[0]} launches, {syncs[0]} syncs "
            f"at {where}; the two profiled runs {t_probe:.1f} s)")
        results[family] = out
        if not np.array_equal(out[True][-2], out[False][-2]):
            fail(f"phase 27: {label}: the counted p-map is not the "
                 f"materialized one")

        # the same descriptors in float64 NumPy on the seeded voxels
        dist = out[True][-1]
        xs = sur.draw_descriptors(family, SEED + 1 + k, n, ST_SUBJECTS,
                                  n_trs=ST_TRS)
        t0 = time.perf_counter()
        if shift:
            ref = shift_nulls_float64(family, data[:, vox], xs)
            card = dist[:, vox]
            err = float(np.max(np.abs(card - ref)))
            ok = err <= ST_SHIFT_ATOL
            obs_ref = np.median(shift_nulls_float64(
                "circular_timeshift", data[:, vox],
                np.zeros((1, ST_SUBJECTS), dtype=np.int64)), axis=0)
            p_card = out[True][1][vox]
            p_ref = (np.sum(ref >= obs_ref, axis=0) + 1) / (n + 1)
            what = f"all {n} resamples"
        else:
            m = ST_ISC_REF
            ref = isc_nulls_float64(family, iscs[:, vox], xs[:m], group)
            card = dist[:m, vox]
            err = float(np.max(np.abs(card - ref)))
            ok = np.array_equal(card, ref)
            obs = out[True][0][..., vox].reshape(-1)
            shifted_c = card - obs if family == "subject_bootstrap" \
                else card
            shifted_r = ref - obs if family == "subject_bootstrap" \
                else ref
            p_card = (np.sum(shifted_c >= obs, axis=0) + 1) / (m + 1)
            p_ref = (np.sum(shifted_r >= obs, axis=0) + 1) / (m + 1)
            what = f"the first {m} resamples"
        counts = np.abs(p_card - p_ref) * (len(card) + 1)
        same = float(np.mean(counts < 0.5))
        log(f"    {ST_SAMPLED} voxels x {what} against float64 NumPy "
            f"({time.perf_counter() - t0:.1f} s): max |diff| {err:.3e}"
            f" ({'bit for bit' if not shift else f'atol {ST_SHIFT_ATOL}'}"
            f"); p equal on {same:.4f} of them, at most "
            f"{int(round(float(counts.max())))} counts apart")
        if not ok:
            fail(f"phase 27: {label}: the card's null disagrees with "
                 f"float64 NumPy")
        if same < ST_P_AGREE or counts.max() > ST_P_COUNTS + 1e-6:
            fail(f"phase 27: {label}: p-values disagree with float64 "
                 f"NumPy")
        del dist
        out[True] = None
        torch.cuda.empty_cache()

    # 'mean' summaries of two ISC-input families on the card, float64
    x = torch.as_tensor(iscs, device=dev)
    for family, null in (("subject_bootstrap", sur.bootstrap_null),
                         ("sign_flip", sur.sign_flip_null)):
        xs = sur.draw_descriptors(family, SEED + 9, 256, ST_SUBJECTS)
        got = null(x, torch.as_tensor(xs, device=dev), "mean")
        ref = isc_nulls_float64(family, iscs[:, vox], xs,
                                statistic="mean")
        err = float(np.max(np.abs(got.cpu().numpy()[:, vox] - ref)))
        log(f"    {family}, 'mean', 256 resamples x {ST_SAMPLED} voxels "
            f"against float64 NumPy: max |diff| {err:.3e} (atol "
            f"{ST_MEAN_ATOL})")
        if not err <= ST_MEAN_ATOL:
            fail(f"phase 27: the 'mean' {family} null disagrees with "
                 f"float64 NumPy")

    # a preempted bootstrap resumed: bit for bit the counted run's (in
    # chunks of 256 resamples, the default budget's at 65,536 voxels)
    engine = eng.NullEngine(device=dev, budget_bytes=16 * ST_VOXELS * 256)
    observed = results["subject_bootstrap"][False][0]
    kw = dict(statistic="median", side="right", seed=SEED + 1,
              observed=observed, center=observed, checkpoint_every=20)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        try:
            with faults.inject("preempt", at_step=2):
                engine.run(iscs, "subject_bootstrap", 10000,
                           checkpoint_dir=ckpt, **kw)
            fail("phase 27: the injected preemption did not fire")
        except faults.PreemptionError:
            pass
        resumed = engine.run(iscs, "subject_bootstrap", 10000,
                             checkpoint_dir=ckpt, **kw)
        secs = time.perf_counter() - t0
    _, ci, p, _ = results["subject_bootstrap"][False]
    same = np.array_equal(resumed.p_values(), p) and all(
        np.array_equal(a, b) for a, b in zip(resumed.ci(95), ci))
    log(f"  bootstrap preempted after its first checkpoint (chunk 20 of "
        f"40) and resumed ({smi}): {secs:.1f} s in all; p and CI equal "
        f"to the uninterrupted run's: {same}")
    if not same:
        fail("phase 27: the resumed bootstrap differs from the "
             "uninterrupted run")


def es_data(n_vox, n_trs, k, seed):
    """Phase 28's planted segmentation (``run_baselines.bench_eventseg``'s
    recipe), float32, and a held-out run of the same events."""
    rng = np.random.RandomState(seed)
    bounds = np.sort(rng.choice(np.arange(1, n_trs), k - 1,
                                replace=False))
    labels = np.searchsorted(bounds, np.arange(n_trs), side='right')
    pat = rng.randn(k, n_vox)
    d = pat[labels] + 0.5 * rng.randn(n_trs, n_vox)
    held = pat[labels] + 0.5 * rng.randn(n_trs, n_vox)
    return d.astype(np.float32), held.astype(np.float32), labels


def es_step_counts(torch, k, d, dev):
    """Kernel launches and host syncs an annealing step: a fit of at
    most 3 steps less a fit of 1 (the setup cancels), over the steps
    between them."""
    from brainiak_tpu_torch.eventseg import EventSegment

    out = []
    for n_iter in (1, 3):
        box = {}

        def fit():
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                es = EventSegment(k, n_iter=n_iter, device=dev).fit(d)
                torch.cuda.synchronize()
            # steps run: the accepted ones and a rejected last one
            box["prof"] = prof
            box["steps"] = min(n_iter, len(es.ll_) + 1)

        syncs, _ = count_syncs(torch, fit)
        out.append((launch_counts(torch, box["prof"])[0], syncs,
                    box["steps"]))
    steps = max(out[1][2] - out[0][2], 1)
    return (out[1][0] - out[0][0]) / steps, (out[1][1] - out[0][1]) / steps


def run_eventseg_phase(torch, smi, dev="cuda"):
    """Phase 28: ``EventSegment`` fits of a planted segmentation at the
    baseline's full tier (V=100, T=500, K=40) and a movie-length run
    (V=1,000, T=1,976, K=50), float32: warm fit seconds, annealing
    steps, launches and syncs a step, boundary accuracy, peak memory;
    ``ll_`` within 1e-4 of a float64 fit on the card; a checkpointed
    fit preempted and resumed bit for bit the unbroken one;
    ``find_events`` on held-out data."""
    import os
    import tempfile

    from brainiak_tpu_torch.eventseg import EventSegment
    from brainiak_tpu_torch.resilience import faults

    warm, _, _ = es_data(20, 60, 5, SEED + 40)
    EventSegment(5, device=dev).fit(warm)
    for t, (label, n_vox, n_trs, k) in enumerate(ES_TIERS):
        d, held, labels = es_data(n_vox, n_trs, k, SEED + 41 + t)
        launches, syncs = es_step_counts(torch, k, d, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        es = EventSegment(k, device=dev).fit(d)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        n_acc = len(es.ll_)
        acc = float(np.mean(np.argmax(es.segments_[0], axis=1) == labels))
        log(f"phase 28, EventSegment, {label} V={n_vox} T={n_trs} K={k} "
            f"float32 ({smi}): fit {secs:.3f} s warm, {n_acc} annealing "
            f"steps accepted ({n_acc + 1} run), {secs / (n_acc + 1):.4f} s "
            f"a step, {launches:.0f} kernel launches and {syncs:.0f} host "
            f"syncs a step, boundary accuracy {acc:.4f}, peak device "
            f"memory {peak:.1f} MiB")
        n_iter = ES_F64_STEPS
        t0 = time.perf_counter()
        ref = EventSegment(k, n_iter=n_iter, device=dev).fit(
            d.astype(np.float64))
        secs64 = time.perf_counter() - t0
        n = min(len(ref.ll_), n_acc)
        rel = float(np.max(np.abs(es.ll_[1:n] - ref.ll_[1:n])) /
                    np.max(np.abs(ref.ll_[1:n])))
        rel0 = float(np.max(np.abs(es.ll_[0] - ref.ll_[0])) /
                     np.max(np.abs(ref.ll_[0])))
        log(f"  float64 fit on the card, {n_iter} steps at most: "
            f"{len(ref.ll_)} accepted in {secs64:.3f} s; ll_ of steps 2-{n} "
            f"max |d| / max |ll| {rel:.3e} (rtol {ES_LL_RTOL}; step 1, "
            f"whose pattern is rounding noise: {rel0:.3e})")
        if not rel <= ES_LL_RTOL:
            fail(f"phase 28: {label}: the float32 ll_ is off the float64 "
                 f"fit's")
        seg, test_ll = es.find_events(held)
        held_acc = float(np.mean(np.argmax(seg, axis=1) == labels))
        log(f"  find_events on held-out data: {seg.shape}, ll "
            f"{test_ll:.3f}, boundary accuracy {held_acc:.4f}")
        if seg.shape != (n_trs, k) or not np.isfinite(test_ll) or \
                not np.allclose(seg.sum(axis=1), 1.0, atol=1e-4):
            fail(f"phase 28: {label}: find_events on held-out data")
        if t:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "ckpt")
            t0 = time.perf_counter()
            try:
                with faults.inject("preempt", at_step=2):
                    EventSegment(k, device=dev).fit(
                        d, checkpoint_dir=ckpt, checkpoint_every=25)
                fail("phase 28: the injected preemption did not fire")
            except faults.PreemptionError:
                pass
            resumed = EventSegment(k, device=dev).fit(
                d, checkpoint_dir=ckpt, checkpoint_every=25)
            secs = time.perf_counter() - t0
        same = np.array_equal(resumed.ll_, es.ll_) and \
            np.array_equal(resumed.event_pat_, es.event_pat_) and \
            np.array_equal(resumed.segments_[0], es.segments_[0])
        log(f"  checkpointed fit (every 25 steps) preempted at step 25 and "
            f"resumed ({secs:.3f} s in all): bit for bit the unbroken "
            f"fit: {same}")
        if not same:
            fail("phase 28: the resumed fit differs from the unbroken one")


# -- phases 29-31: TFA, HTFA, the encoding tier -------------------------

TFA_GRID = (64, 64, 16)   # 65,536 voxels
TFA_SPACING = 3.0         # mm
TFA_ORIGIN = (100.0, 120.0, 150.0)  # mm: a scanner origin off zero
TFA_TRS = 600
TFA_K = 50
FA_F64_RTOL = 1e-5        # float32 RBF ops, objective, gradient vs float64
TFA_RECON_RTOL = 1e-2     # float32 reconstruction error vs float64's
TFA_RECOVERY = 0.9        # float32 recovers >= 90% of float64's factors
HTFA_SUBJECTS = 20
HTFA_TRS = 300
# max_global_iter, max_local_iter: a depth cut of the default 10 x 10.
# A subject step is one host-driven L-BFGS (about 0.38 s on an H100),
# so 3 x 3 took 85 s a fit of 20 subjects there, and the phase's three
# fits did not fit the run's time limit beside the earlier phases
HTFA_ITERS = (2, 2)
HTFA_TEMPLATE_ATOL = 3.0  # mm, one grid step: float32 vs float64 template
HTFA_POSITIONS = 4
HTFA_RANK_SUBJECTS = 8    # the two gloo ranks' fit (phase 23's spawn)
HTFA_RANK_ITERS = (2, 2)
ENC_SHAPE = (4000, 2048, 65536)   # T, F, V
ENC_BLOCK = 2             # lambda_block: about 8 GB transient
ENC_CHECK = 2048          # voxels held to the float64 CV
ENC_CV_ATOL = 1e-4
ENC_AGREE = 0.99          # share of voxels whose lambdas are equal
ENC_W_RTOL = 1e-3         # of max|W|
ENC_BANDED_F = 1024       # two bands of 512
ENC_CAND_BLOCK = 4
ENC_BUDGET = 1 << 20      # bytes: the meshed fit's Gram takes the ring


def step_counts(torch, fn):
    """(kernel launches the host made, host syncs, {line: syncs}) of
    one ``fn()``, profiled under sync debug mode."""
    box = {}

    def run():
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
        box["prof"] = prof

    syncs, where = count_syncs(torch, run)
    return launch_counts(torch, box["prof"])[0], syncs, where


def fa_grid():
    """Phases 29-30's coordinates [65,536, 3] (mm): the 64 x 64 x 16
    grid at 3 mm from ``TFA_ORIGIN``, exact in float32."""
    idx = np.indices(TFA_GRID).reshape(3, -1).T
    return np.asarray(TFA_ORIGIN) + TFA_SPACING * idx


def fa_planted(rng, k):
    """``k`` planted centres inside the grid (two steps from its faces)
    and widths of 200-800 mm², both exact in float32."""
    lo = np.asarray(TFA_ORIGIN) + 2 * TFA_SPACING
    hi = np.asarray(TFA_ORIGIN) + TFA_SPACING * (np.asarray(TFA_GRID) - 3)
    centers = lo + (hi - lo) * rng.rand(k, 3)
    widths = 200.0 + 600.0 * rng.rand(k, 1)
    return (centers.astype(np.float32).astype(np.float64),
            widths.astype(np.float32).astype(np.float64))


def tfa_data(seed):
    """Phase 29's subject: X = F(planted) W + 0.1 noise, float32."""
    rng = np.random.RandomState(seed)
    R = fa_grid()
    centers, widths = fa_planted(rng, TFA_K)
    F = np.exp(-((R[:, None, :] - centers[None]) ** 2).sum(-1) / widths.T)
    X = F @ rng.randn(TFA_K, TFA_TRS) + 0.1 * rng.randn(R.shape[0], TFA_TRS)
    return X.astype(np.float32), R, centers, widths


def matched_distances(est, planted):
    """Distances (mm) of the Hungarian matching of ``est`` to
    ``planted`` centres."""
    from scipy.optimize import linear_sum_assignment
    from scipy.spatial import distance

    cost = distance.cdist(planted, est)
    rows, cols = linear_sum_assignment(cost)
    return cost[rows, cols]


def recovery_line(d):
    return (f"{int(np.sum(d <= TFA_SPACING))}/{d.size} within a grid step, "
            f"matched distance median {np.median(d):.3f} mm, max "
            f"{d.max():.3f} mm")


def fa_op_errors(torch, dev, X, R, centers, widths, tmpl):
    """Phase 29's gate on the ops: rbf_factors, rbf_weight_products,
    rbf_residual_sum (linear and soft-L1) and the NLLS objective's
    value and gradient (TFA's: linear, no template; HTFA's: soft-L1
    with a template) in float32 against float64 on the card, at fixed
    parameters away from the optimum on a subsample of 5,000 x 500.
    ``{name: relative error}``."""
    from brainiak_tpu_torch.factoranalysis import tfa as ttfa
    from brainiak_tpu_torch.ops import rbf
    from brainiak_tpu_torch.ops.optimize import _value_and_grad

    rng = np.random.RandomState(SEED + 52)
    feat = rng.choice(X.shape[0], min(5000, X.shape[0]), replace=False)
    samp = rng.choice(X.shape[1], min(500, X.shape[1]), replace=False)
    sub, sub_r = X[feat][:, samp], R[feat]
    k = centers.shape[0]
    c = (centers + 6.0 * rng.randn(*centers.shape)).astype(np.float32)
    w = (1.5 * widths).astype(np.float32)
    sigma = float(np.std(sub) / np.sqrt(2.0))
    out = {}
    res = {}
    for dt in (torch.float64, torch.float32):
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        r_, x_, c_, w_ = t(sub_r), t(sub), t(c), t(w)
        f = rbf.rbf_factors(r_, c_, w_)
        g, b = rbf.rbf_weight_products(r_, c_, w_, x_)
        if dt == torch.float64:
            wmat = torch.linalg.solve(
                g + torch.var(x_, unbiased=False) * torch.eye(
                    k, dtype=dt, device=dev), b)
        wm = wmat.to(dt)
        sums = [rbf.rbf_residual_sum(r_, c_, w_, x_, wm, sigma,
                                     nlss_loss=loss)
                for loss in ("linear", "soft_l1")]
        params = torch.cat([c_.reshape(-1), w_.reshape(-1)])
        objs = []
        for loss, with_tmpl in (("linear", False), ("soft_l1", True)):
            objs += list(_value_and_grad(
                lambda p: ttfa._nlls_objective(
                    p, r_, x_, wm, sigma, 0.05, *(t(a) for a in tmpl), K=k,
                    n_dim=3, nlss_loss=loss, has_template=with_tmpl),
                params))
        res[dt] = [f, g, b] + sums + objs
    names = ["rbf_factors", "FtF", "FtX", "residual sum linear",
             "residual sum soft_l1", "objective TFA", "gradient TFA",
             "objective HTFA", "gradient HTFA"]
    for name, a, b in zip(names, res[torch.float32], res[torch.float64]):
        diff = (a.double() - b)
        if name.startswith("gradient"):
            out[name] = float(torch.linalg.vector_norm(diff) /
                              torch.linalg.vector_norm(b))
        else:
            out[name] = float(diff.abs().max() / b.abs().max())
    return out


def recon_error(torch, model, x64):
    """``||X - F_ W_|| / ||X||`` in float64 on ``x64``'s device."""
    f = torch.as_tensor(model.F_, dtype=torch.float64, device=x64.device)
    w = torch.as_tensor(model.W_, dtype=torch.float64, device=x64.device)
    return float(torch.linalg.vector_norm(x64 - f @ w) /
                 torch.linalg.vector_norm(x64))


def run_tfa_phase(torch, smi, dev="cuda"):
    """Phase 29: TFA on one subject of 65,536 voxels (64 x 64 x 16 at
    3 mm, a scanner origin 100-150 mm off zero) x 600 TRs, K=50 planted
    factors, the reference's defaults (5,000 voxels x 500 TRs a
    subsample, 10 iterations, 60 L-BFGS steps): fits in float32 and
    float64; the ops, the objective and its gradient in float32 against
    float64 (``FA_F64_RTOL``); the float32 fit's reconstruction error
    within ``TFA_RECON_RTOL`` of the float64 fit's; recovery of the
    planted centres; launches and syncs of an iteration."""
    from brainiak_tpu_torch.factoranalysis import TFA

    t0 = time.perf_counter()
    X, R, centers, widths = tfa_data(SEED + 50)
    log(f"phase 29, TFA ({smi}): {X.shape[0]} voxels on a {TFA_GRID} grid "
        f"at {TFA_SPACING} mm from {TFA_ORIGIN} mm x {X.shape[1]} TRs, "
        f"K={TFA_K}, planted; data made in {time.perf_counter() - t0:.1f} s")
    x64 = torch.as_tensor(X, dtype=torch.float64, device=dev)
    fits, recon, recovered = {}, {}, {}
    for name, data in (("float32", X), ("float64", X.astype(np.float64))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = TFA(K=TFA_K, device=dev).fit(data, R)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        fits[name] = model
        d = matched_distances(model.get_centers(model.local_posterior_),
                              centers)
        err = recon_error(torch, model, x64)
        log(f"  {name} fit: {secs:.3f} s ({model.miter} iterations of "
            f"{model.max_num_voxel} x {model.max_num_tr}), peak device "
            f"memory {peak:.1f} MiB; reconstruction error {err:.6f}; "
            f"planted centres: {recovery_line(d)}")
        recon[name] = err
        recovered[name] = int(np.sum(d <= TFA_SPACING))
    rel = abs(recon["float32"] - recon["float64"]) / recon["float64"]
    log(f"  float32 vs float64 reconstruction error: {rel:.3e} relative "
        f"(rtol {TFA_RECON_RTOL})")
    if not rel <= TFA_RECON_RTOL:
        fail("phase 29: the float32 TFA fit is off the float64 fit")
    n32, n64 = recovered["float32"], recovered["float64"]
    if n32 < TFA_RECOVERY * n64:
        fail(f"phase 29: float32 recovers {n32} planted centres, float64 "
             f"{n64}")
    m = fits["float32"]
    tmpl_cov = np.cov(R.T) * TFA_K ** (-2 / 3.0)
    tmpl = (centers, np.tile(np.linalg.inv(tmpl_cov), (TFA_K, 1, 1)),
            widths, np.full((TFA_K, 1), 1.0 / m._get_max_sigma(R)))
    errs = fa_op_errors(torch, dev, X, R, centers, widths, tmpl)
    log("  float32 vs float64 on the card, at fixed parameters: " +
        ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) +
        f" (rtol {FA_F64_RTOL})")
    if not max(errs.values()) <= FA_F64_RTOL:
        fail("phase 29: a float32 RBF op or the objective is off float64")

    def seeding():
        m.init_centers_widths(R)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    seeding()
    secs = time.perf_counter() - t0
    launches, syncs, _ = step_counts(torch, seeding)
    log(f"  the seeding k-means (k-means++ and Lloyd, 10 runs batched, "
        f"K={TFA_K}, float64 on the card): {secs:.3f} s, {launches} kernel "
        f"launches, {syncs} host syncs")

    def step():
        m._fit_tfa_inner(X, R, None, None, None, None)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    step()
    secs = time.perf_counter() - t0
    launches, syncs, where = step_counts(torch, step)
    top = sorted(where.items(), key=lambda kv: -kv[1])[:3]
    log(f"  an iteration (subsample, weight solve, L-BFGS): {secs:.3f} s, "
        f"{launches} kernel launches, {syncs} host syncs (most at {top})")
    del x64
    torch.cuda.empty_cache()


def htfa_data(torch, n_subj, seed, dev):
    """HTFA's subjects on the phase-29 grid: centres jittered by 2 mm
    and widths by 10% around a planted template; X_s = F_s W_s + 0.1
    noise, made on ``dev`` from the seed, float32 on the host."""
    from brainiak_tpu_torch.ops.rbf import rbf_factors

    rng = np.random.RandomState(seed)
    R = fa_grid()
    centers, widths = fa_planted(rng, TFA_K)
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = torch.as_tensor(R, device=dev)
    X = []
    for _ in range(n_subj):
        c = centers + 2.0 * rng.randn(*centers.shape)
        w = widths * np.clip(1.0 + 0.1 * rng.randn(*widths.shape), 0.5,
                             1.5)
        f = rbf_factors(r, torch.as_tensor(c, device=dev),
                        torch.as_tensor(w, device=dev))
        wm = torch.randn(TFA_K, HTFA_TRS, generator=gen, device=dev,
                         dtype=torch.float64)
        noise = torch.randn(R.shape[0], HTFA_TRS, generator=gen,
                            device=dev, dtype=torch.float64)
        X.append((f @ wm + 0.1 * noise).float().cpu().numpy())
    return X, [R] * n_subj, centers


def htfa_kw(n_subj, iters):
    return dict(K=TFA_K, n_subj=n_subj, max_global_iter=iters[0],
                max_local_iter=iters[1])


def htfa_fit(torch, X, R, seed, kw, **extra):
    """One seeded HTFA fit: (model, seconds, peak MiB)."""
    from brainiak_tpu_torch.factoranalysis import HTFA

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    np.random.seed(seed)
    t0 = time.perf_counter()
    model = HTFA(**kw, **extra).fit(X, R)
    torch.cuda.synchronize()
    return (model, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 20)


def htfa_fields(model):
    return (model.global_posterior_, model.local_posterior_,
            model.local_weights_)


def htfa_on_ranks(torch, dev="cuda"):
    """HTFA on a subject mesh of the ranks (phase 23's spawn): 8
    subjects, 2 x 2 iterations; this rank's fit and seconds."""
    from brainiak_tpu_torch.parallel import make_mesh

    X, R, _ = htfa_data(torch, HTFA_RANK_SUBJECTS, SEED + 61, dev)
    model, secs, _ = htfa_fit(
        torch, X, R, SEED + 62,
        htfa_kw(HTFA_RANK_SUBJECTS, HTFA_RANK_ITERS), device=dev,
        mesh=make_mesh(("subject",), (-1,)))
    return {"fields": htfa_fields(model), "secs": secs}


def run_htfa_phase(torch, smi, ranks, dev="cuda"):
    """Phase 30: HTFA on 20 subjects of 65,536 voxels x 300 TRs,
    float32, K=50, the default ratios and caps (5,000 voxels, 30 TRs a
    subsample), soft-L1, ``HTFA_ITERS`` iterations (a depth cut of the
    default 10 x 10): a meshless fit, a fit on a 4-position subject mesh of the
    card (bit for bit the meshless one) and a float64 fit (template
    centres matched within ``HTFA_TEMPLATE_ATOL``); template recovery;
    seconds, launches and syncs of a subject step.  Then the two gloo
    ranks' fit of phase 23 (``ranks``) against the one-process fit at
    its settings, bit for bit."""
    from brainiak_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    X, R, centers = htfa_data(torch, HTFA_SUBJECTS, SEED + 60, dev)
    log(f"phase 30, HTFA ({smi}): {HTFA_SUBJECTS} subjects x "
        f"{X[0].shape[0]} voxels x {HTFA_TRS} TRs float32, K={TFA_K}, "
        f"{HTFA_ITERS[0]} x {HTFA_ITERS[1]} iterations (a depth cut of the "
        f"default 10 x 10, forced by the run's time limit); data made in "
        f"{time.perf_counter() - t0:.1f} s")
    kw = htfa_kw(HTFA_SUBJECTS, HTFA_ITERS)
    single, secs, peak = htfa_fit(torch, X, R, SEED + 63, kw, device=dev)
    steps = HTFA_SUBJECTS * HTFA_ITERS[0] * HTFA_ITERS[1]
    log(f"  float32 fit: {secs:.3f} s (at most {steps} subject steps of "
        f"{single.sub_nvox[0]} x {single.sub_ntr[0]}), peak device memory "
        f"{peak:.1f} MiB")
    mesh = make_mesh(("subject",), (HTFA_POSITIONS,),
                     devices=[dev] * HTFA_POSITIONS)
    meshed, secs, _ = htfa_fit(torch, X, R, SEED + 63, kw, device=dev,
                               mesh=mesh)
    same = all(np.array_equal(a, b) for a, b in
               zip(htfa_fields(meshed), htfa_fields(single)))
    log(f"  on a {HTFA_POSITIONS}-position subject mesh of the card: "
        f"{secs:.3f} s, bit for bit the meshless fit: {same}")
    if not same:
        fail("phase 30: the meshed HTFA fit differs from the meshless fit")
    del meshed
    f64, secs, _ = htfa_fit(torch, [x.astype(np.float64) for x in X], R,
                            SEED + 63, kw, device=dev)
    c32 = single.get_centers(single.global_posterior_)
    c64 = f64.get_centers(f64.global_posterior_)
    d = matched_distances(c32, c64)
    log(f"  float64 fit: {secs:.3f} s; float32 template centres vs "
        f"float64's, matched: median {np.median(d):.4f} mm, max "
        f"{d.max():.4f} mm (atol {HTFA_TEMPLATE_ATOL} mm)")
    if not d.max() <= HTFA_TEMPLATE_ATOL:
        fail("phase 30: the float32 HTFA template is off the float64 one")
    for name, c in (("float32", c32), ("float64", c64)):
        log(f"  {name} template vs the planted centres: "
            f"{recovery_line(matched_distances(c, centers))}")
    # a subject step, as the fit runs it: subject 0 of the last global
    # iteration's template
    tmpl = single._template_terms()
    rng = np.random.RandomState(0)
    curr, curr_r, beta, sigma = single._gather_subsample(X[0], R[0], rng, 0)
    prior = single.global_prior_[:single.prior_size]

    def step():
        single._subject_step(curr, curr_r, prior, 0, beta, sigma, tmpl,
                             torch.device(dev))
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    step()
    secs = time.perf_counter() - t0
    launches, syncs, where = step_counts(torch, step)
    top = sorted(where.items(), key=lambda kv: -kv[1])[:3]
    log(f"  a subject step (weight solve, bounded L-BFGS of "
        f"{single.lbfgs_iters} steps at most, one subject after another on "
        f"the host): {secs:.3f} s, {launches} kernel launches, {syncs} host "
        f"syncs (most at {top})")
    del single, f64, X
    torch.cuda.empty_cache()
    # the two gloo ranks' fit (run in phase 23's spawn) against one process
    X, R, _ = htfa_data(torch, HTFA_RANK_SUBJECTS, SEED + 61, dev)
    one, secs, _ = htfa_fit(torch, X, R, SEED + 62,
                            htfa_kw(HTFA_RANK_SUBJECTS, HTFA_RANK_ITERS),
                            device=dev)
    same = [all(np.array_equal(a, b) for a, b in
                zip(r["fields"], htfa_fields(one))) for r in ranks]
    rank_secs = ", ".join(f"{r['secs']:.3f}" for r in ranks)
    log(f"  two gloo ranks ({HTFA_RANK_SUBJECTS} subjects, "
        f"{HTFA_RANK_ITERS[0]} x {HTFA_RANK_ITERS[1]} iterations): rank "
        f"seconds {rank_secs}, one process {secs:.3f} s; each rank bit for "
        f"bit the one-process fit: {same}")
    if not all(same):
        for r in ranks:
            diff = max(float(np.abs(a - b).max()) for a, b in
                       zip(r["fields"], htfa_fields(one)))
            log(f"    max |rank - one process| {diff:.3e}")
        fail("phase 30: the two-rank HTFA fit differs from one process")


def enc_data(torch, dev, seed, n_bands=1):
    """Phase 31's design X [T, F] ~ N(0, 1) and responses Y = X W + N(0,
    1) with W's columns ~ N(0, 1/lambda*), lambda* log-uniform a voxel
    (and a band) in [10^2.5, 10^4.5] (ridge) or [10^3, 10^4.5]
    (banded): the best lambdas lie above the flat region where the
    smaller ones tie (a lambda far below the Gram's eigenvalues, about
    1,600-9,000 a band, changes the CV score by about 1e-6, float32's
    own noise).  Made on ``dev``; float32 on the host."""
    t, f, v = ENC_SHAPE
    f = ENC_BANDED_F if n_bands > 1 else f
    lo = 3.0 if n_bands > 1 else 2.5
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(t, f, generator=gen, device=dev)
    y = torch.randn(t, v, generator=gen, device=dev)
    width = f // n_bands
    for b in range(n_bands):
        lam = 10 ** (lo + (4.5 - lo) * torch.rand(v, generator=gen,
                                                  device=dev))
        w = torch.randn(width, v, generator=gen, device=dev) / lam.sqrt()
        y += x[:, b * width:(b + 1) * width] @ w
    return x.cpu().numpy(), y.cpu().numpy()


def ridge_float64(torch, x, y, penalties, n_folds, dev):
    """The CV of ridge with per-feature ``penalties`` [C, F] (a lambda
    a feature: the banded scaling trick solved directly) in float64 on
    ``dev`` by Cholesky solves: ``(scores [C, V], refit(rows) -> W [F,
    V] at each voxel's penalty row)``.  The design and responses are
    centred in float64."""
    x = torch.as_tensor(x, dtype=torch.float64, device=dev)
    y = torch.as_tensor(y, dtype=torch.float64, device=dev)
    x = x - x.mean(0)
    y = y - y.mean(0)
    t_f = x.shape[0] // n_folds
    g_total, b_total = x.T @ x, x.T @ y
    pen = torch.as_tensor(penalties, dtype=torch.float64, device=dev)
    scores = torch.zeros((pen.shape[0], y.shape[1]), dtype=torch.float64,
                         device=dev)
    for k in range(n_folds):
        xk, yk = x[k * t_f:(k + 1) * t_f], y[k * t_f:(k + 1) * t_f]
        g, b = g_total - xk.T @ xk, b_total - xk.T @ yk
        for c in range(pen.shape[0]):
            chol = torch.linalg.cholesky(g + torch.diag(pen[c]))
            pred = xk @ torch.cholesky_solve(b, chol)
            pc, yc = pred - pred.mean(0), yk - yk.mean(0)
            den = torch.sqrt((pc * pc).sum(0) * (yc * yc).sum(0))
            scores[c] += torch.where(den > 0, (pc * yc).sum(0) / den, 0.0)

    def refit(rows):
        w = torch.zeros_like(b_total)
        for c in np.unique(rows):
            cols = torch.as_tensor(np.nonzero(rows == c)[0], device=dev)
            chol = torch.linalg.cholesky(g_total + torch.diag(pen[c]))
            w[:, cols] = torch.cholesky_solve(b_total[:, cols], chol)
        return w.cpu().numpy()

    return (scores / n_folds).cpu().numpy(), refit


def scaled_eigh_cv(torch, x, y, scales, n_folds, dev):
    """The JAX package's banded CV (``encoding/ridge.py``'s
    ``_banded_sweep_program``) in float32 on ``dev``: per candidate, an
    ``eigh`` of the scaled train Grams ``diag(s) G diag(s)`` and a
    ridge at lambda 1, for the columns of ``y``.  Returns [C, V]."""
    from brainiak_tpu_torch.encoding import ridge as tridge

    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    x, y = x - x.mean(0), y - y.mean(0)
    t_f = x.shape[0] // n_folds
    x_folds, y_folds, g_tr, b_tr, _ = tridge._fold_algebra(
        x, y, x.T @ x, n_folds, t_f, torch.float32)
    out = []
    for s in torch.as_tensor(scales, device=dev):
        evals, q = torch.linalg.eigh(g_tr * s[None, :, None] *
                                     s[None, None, :])
        evals = torch.clamp(evals, min=0.0)
        a = torch.einsum('kfg,kfv->kgv', q, b_tr * s[None, :, None])
        p = torch.einsum('ktf,kfg->ktg', x_folds * s[None, None, :], q)
        pred = torch.einsum('ktf,kfv->ktv', p, a / (evals[..., None] + 1.0))
        out.append(tridge._fold_scores(pred, y_folds).mean(0))
    return torch.stack(out).cpu().numpy()


def enc_fit(torch, fit, *args):
    """One call of an encoder's ``fit``: (model, seconds, peak MiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = fit(*args)
    torch.cuda.synchronize()
    return (model, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 20)


def run_encoding_phase(torch, smi, rows, dev="cuda"):
    """Phase 31, the encoding tier: ``RidgeEncoder`` at T=4,000, F=2,048,
    V=65,536, ``DEFAULT_LAMBDAS``, 5 folds, ``lambda_block=2``, against a
    float64 Cholesky CV on the card for 2,048 voxels; on a 4-position
    voxel mesh of the card with the distla budget at 1 MiB, so that its
    Gram takes the ring (K5, 4 steps x 4 positions); then
    ``BandedRidgeEncoder`` at F=1,024 in two bands of 512, 7 x 7
    candidates, ``candidate_block=4``, against the float64 CV.  Sets
    the launches of K5's row at the ridge's shape."""
    import os

    from brainiak_tpu_torch.encoding import (DEFAULT_LAMBDAS,
                                             BandedRidgeEncoder,
                                             RidgeEncoder)
    from brainiak_tpu_torch.encoding import ridge as tridge
    from brainiak_tpu_torch.ops import distla
    from brainiak_tpu_torch.ops.kernels import ring as kr
    from brainiak_tpu_torch.parallel import make_mesh

    t, f, v = ENC_SHAPE
    nc = ENC_CHECK
    t0 = time.perf_counter()
    x, y = enc_data(torch, dev, SEED + 70)
    log(f"phase 31, the encoding tier ({smi}): RidgeEncoder T={t}, F={f}, "
        f"V={v}, lambdas {DEFAULT_LAMBDAS}, 5 folds, lambda_block="
        f"{ENC_BLOCK}; data made in {time.perf_counter() - t0:.1f} s")
    enc, secs, peak = enc_fit(torch, RidgeEncoder(
        lambda_block=ENC_BLOCK, device=dev).fit, x, y)
    log(f"  fit {secs:.3f} s, peak device memory {peak:.1f} MiB")
    grid = enc.lambdas_
    t0 = time.perf_counter()
    cv64, refit = ridge_float64(torch, x, y[:, :nc],
                                np.repeat(grid[:, None], f, axis=1), 5,
                                dev)
    lam64 = grid[np.argmax(cv64, axis=0)]
    sel = np.searchsorted(grid, enc.lambda_[:nc])
    w64 = refit(sel)
    cv_err = float(np.abs(enc.cv_scores_[:, :nc] - cv64).max())
    agree = float(np.mean(enc.lambda_[:nc] == lam64))
    w_err = float(np.abs(enc.W_[:, :nc] - w64).max() / np.abs(w64).max())
    log(f"  against float64 on {nc} voxels ({time.perf_counter() - t0:.1f} "
        f"s): cv_scores_ max |d| {cv_err:.3e} (atol {ENC_CV_ATOL}), lambda_ "
        f"equal on {agree:.4f} (>= {ENC_AGREE}), W_ at the selected lambdas "
        f"max |d| / max |W| {w_err:.3e} (rtol {ENC_W_RTOL}); lambdas "
        f"selected {dict(zip(*np.unique(enc.lambda_, return_counts=True)))}")
    if not (cv_err <= ENC_CV_ATOL and agree >= ENC_AGREE and
            w_err <= ENC_W_RTOL):
        fail("phase 31: RidgeEncoder is off the float64 CV")
    # the Gram on the ring of a 4-position mesh of the card; one sweep
    # block profiled
    sweep, box = tridge._sweep, {}

    def profiled(*args, **kw):
        if "counts" not in box:
            box["counts"] = step_counts(
                torch, lambda: sweep(*args, **kw).cpu())
        return sweep(*args, **kw)

    mesh = make_mesh(("voxel",), (4,), devices=[dev] * 4)
    prev = os.environ.get(distla.BUDGET_ENV)
    os.environ[distla.BUDGET_ENV] = str(ENC_BUDGET)
    tridge._sweep = profiled
    kr.reset_launches()
    try:
        ring, secs, _ = enc_fit(torch, RidgeEncoder(
            lambda_block=ENC_BLOCK, mesh=mesh, device=dev).fit, x, y)
    finally:
        tridge._sweep = sweep
        if prev is None:
            del os.environ[distla.BUDGET_ENV]
        else:
            os.environ[distla.BUDGET_ENV] = prev
    k5 = {r: kr.launches(r) for r in (None, "tc", "split")}
    agree = float(np.mean(ring.lambda_ == enc.lambda_))
    w_err = float(np.abs(ring.W_ - enc.W_).max() / np.abs(enc.W_).max())
    launches, syncs, _ = box["counts"]
    log(f"  on a 4-position voxel mesh (distla budget {ENC_BUDGET} bytes): "
        f"{secs:.3f} s with one sweep block profiled, K5 launches "
        f"{k5[None]} ({k5['tc']} tensor-core, {k5['split']} splits); "
        f"lambda_ equal to the meshless fit's on {agree:.5f}, W_ max |d| / "
        f"max |W| {w_err:.3e}; a sweep block of {ENC_BLOCK} lambdas: "
        f"{launches} kernel launches, {syncs} host syncs")
    if not (k5[None] == k5["tc"] == 16 and agree >= ENC_AGREE and
            w_err <= ENC_W_RTOL):
        fail("phase 31: the meshed RidgeEncoder did not run K5 16 times or "
             "is off the meshless fit")
    rows["ring_mma_ridge"]["launches"] = k5["tc"]
    del enc, ring, x, y
    torch.cuda.empty_cache()
    # banded: two bands of 512
    x, y = enc_data(torch, dev, SEED + 71, n_bands=2)
    bands = np.repeat(np.arange(2), ENC_BANDED_F // 2)
    banded, secs, peak = enc_fit(torch, BandedRidgeEncoder(
        bands, candidate_block=ENC_CAND_BLOCK, device=dev).fit, x, y)
    cand = banded.candidates_
    log(f"  BandedRidgeEncoder F={ENC_BANDED_F} in two bands, "
        f"{cand.shape[0]} candidates in blocks of {ENC_CAND_BLOCK}: fit "
        f"{secs:.3f} s, peak device memory {peak:.1f} MiB")
    t0 = time.perf_counter()
    cv64, _ = ridge_float64(torch, x, y[:, :nc], cand[:, bands], 5, dev)
    rows64 = cand[np.argmax(cv64, axis=0)]
    agree = float(np.mean(np.all(banded.lambda_[:nc] == rows64, axis=1)))
    cv_err = float(np.abs(banded.cv_scores_[:, :nc] - cv64).max())
    log(f"  against float64 on {nc} voxels ({time.perf_counter() - t0:.1f} "
        f"s): lambda_ rows equal on {agree:.4f} (>= {ENC_AGREE}), "
        f"cv_scores_ max |d| {cv_err:.3e}")
    if not agree >= ENC_AGREE:
        fail("phase 31: BandedRidgeEncoder selects other lambdas than the "
             "float64 CV")
    # the JAX package's route (an eigh of the scaled Gram a candidate),
    # which the port does not take: reported, not gated
    t0 = time.perf_counter()
    cv_eigh = scaled_eigh_cv(torch, x, y[:, :nc], 1.0 / np.sqrt(
        cand[:, bands]), 5, dev)
    agree = float(np.mean(np.all(
        cand[np.argmax(cv_eigh, axis=0)] == rows64, axis=1)))
    log(f"  the JAX package's route on the same {nc} voxels (an eigh of "
        f"the scaled Gram a candidate and fold, float32; "
        f"{time.perf_counter() - t0:.1f} s): candidates equal to the "
        f"float64 CV's on {agree:.4f}, cv_scores max |d| "
        f"{float(np.abs(cv_eigh - cv64).max()):.3e}")
    del banded, x, y
    torch.cuda.empty_cache()


# phases 32-34: the matrix-normal tier, the inverted encoding models and
# the hyperparameter optimizer
MN_TRS = 600
MN_ONSETS = [0, 300]     # two runs
MN_CONDITIONS = 16
MN_BOX = [16, 16, 8]     # 2,048 voxels; the inscribed ellipsoid kept
MN_RHO = 0.5             # the planted AR(1) coefficient
MN_LOSS_RTOL = 1e-4      # float64 loss at the float32 optimum vs float64's
MN_BETA_CORR = 0.9       # corr(beta-hat, beta), the JAX test's kind of bar
MNRSA_VOXELS = 2048
MNRSA_NUREG = 5
# L-BFGS iterations of the MNRSA fits: at the JAX default of 300 the
# float64 fit stops 13,000 nats (5e-3) short of its optimum on this data;
# by 1,000 both precisions are within 1e-6 of it (float64 on the CPU:
# 1,000 iterations 2429952.56, 3,000 2429918.68)
MNRSA_ITERS = 1000
MNRSA_CORR = 0.7         # off-diagonal corr of C_ with U (the JAX test's)
IEM_TRIALS = 480
IEM_TRAIN = 360
IEM_VOXELS = 2000
IEM_RADIUS = 1.5         # the 2-D stimuli's disc radius (stimulus units)
IEM_1D_DEG = 20.0        # median held-out error (degrees), 1-D
IEM_2D_UNITS = 2.0       # median held-out error (stimulus units), 2-D
IEM_AGREE = 0.95         # float32 predictions equal to float64's
HPO_EVALS = 40
HPO_RANDOM = 10          # fmin's random evaluations before the TPE ones
# the channel FWHM searched (stimulus units): beyond about 2.9 the
# channels overlap so that the fit's weights fail its condition check
HPO_FWHM = (1.0, 2.5)


def mn_ellipsoid():
    """The ellipsoid inscribed in the ``MN_BOX`` voxel box, flat."""
    idx = np.indices(MN_BOX).reshape(3, -1).T
    half = np.asarray(MN_BOX) / 2.0
    return (((idx + 0.5 - half) / half) ** 2).sum(1) <= 1.0


def mn_ar1_noise(rng, n_v):
    """AR(1) noise with ``MN_RHO`` and unit variance, restarted at each
    of ``MN_ONSETS``: [MN_TRS, n_v]."""
    out = np.empty((MN_TRS, n_v))
    for start, stop in zip(MN_ONSETS, MN_ONSETS[1:] + [MN_TRS]):
        out[start] = rng.randn(n_v)
        for t in range(start + 1, stop):
            out[t] = MN_RHO * out[t - 1] + \
                np.sqrt(1 - MN_RHO ** 2) * rng.randn(n_v)
    return out


def matnormal_data(seed):
    """Phase 32's data: a design X [600, 16] ~ N(0, 1), beta [16, 2048]
    ~ N(0, 1), and AR(1) noise (rho 0.5, per run) made smooth in space
    by a Kronecker factor of exp(-|i - j| / 2) along each box axis,
    scaled to 2: Y = X beta + noise."""
    rng = np.random.RandomState(seed)
    X = rng.randn(MN_TRS, MN_CONDITIONS)
    beta = rng.randn(MN_CONDITIONS, int(np.prod(MN_BOX)))
    noise = mn_ar1_noise(rng, beta.shape[1]).reshape([MN_TRS] + MN_BOX)
    for axis, n in enumerate(MN_BOX):
        d = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
        chol = np.linalg.cholesky(np.exp(-d / 2.0))
        noise = np.moveaxis(np.tensordot(chol, noise, (1, axis + 1)), 0,
                            axis + 1)
    return X, X @ beta + 2.0 * noise.reshape(MN_TRS, -1), beta


def mnrsa_data(seed):
    """Phase 33's data: the design X [600, 16] ~ N(0, 1), U of 4 blocks
    of 4 (1 on the diagonal, 0.8 inside a block), W = chol(U) N(0, 1)
    [16, 2048], and AR(1) noise (rho 0.5, per run) of a standard
    deviation 1-3 a voxel: Y = X W + noise."""
    rng = np.random.RandomState(seed)
    U = np.kron(np.eye(4), np.full((4, 4), 0.8) + 0.2 * np.eye(4))
    X = rng.randn(MN_TRS, MN_CONDITIONS)
    W = np.linalg.cholesky(U) @ rng.randn(MN_CONDITIONS, MNRSA_VOXELS)
    sd = 1.0 + 2.0 * rng.rand(MNRSA_VOXELS)
    return X, X @ W + mn_ar1_noise(rng, MNRSA_VOXELS) * sd, U


def lbfgs_counting():
    """A context counting the port's L-BFGS iterations (two-loop
    directions) and its objective evaluations while it is open."""
    import contextlib

    from brainiak_tpu_torch.ops import optimize

    @contextlib.contextmanager
    def counting():
        counts = {"iterations": 0, "evaluations": 0}
        two_loop, value_and_grad = optimize._two_loop, \
            optimize._value_and_grad

        def counted_two_loop(*args):
            counts["iterations"] += 1
            return two_loop(*args)

        def counted_value_and_grad(*args):
            counts["evaluations"] += 1
            return value_and_grad(*args)

        optimize._two_loop = counted_two_loop
        optimize._value_and_grad = counted_value_and_grad
        try:
            yield counts
        finally:
            optimize._two_loop = two_loop
            optimize._value_and_grad = value_and_grad

    return counting()


def mn_fit(torch, make, fit_args, dtype):
    """A matrix-normal estimator's ``_fit`` in ``dtype``: (model,
    seconds, peak MiB, L-BFGS iterations, objective evaluations)."""
    model = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with lbfgs_counting() as counts:
        t0 = time.perf_counter()
        model._fit(*fit_args, dtype)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return (model, secs, torch.cuda.max_memory_allocated() / 2 ** 20,
            counts["iterations"], counts["evaluations"])


def mn_iteration_counts(torch, make, fit_args):
    """Kernel launches and host syncs of one float32 L-BFGS iteration:
    a profiled fit of 2 iterations less one of 1."""
    out = []
    for iters in (1, 2):
        def fit():
            model = make()
            model.max_iters = iters
            model._fit(*fit_args, torch.float32)
            torch.cuda.synchronize()
        launches, syncs, _ = step_counts(torch, fit)
        out.append((launches, syncs))
    return out[1][0] - out[0][0], out[1][1] - out[0][1]


def mn_report(label, fits, per_iter):
    for name, (model, secs, peak, iters, evals) in fits.items():
        log(f"  {label} {name} fit: {secs:.3f} s, {iters} L-BFGS "
            f"iterations ({evals} objective evaluations), "
            f"{secs / max(iters, 1) * 1e3:.3f} ms an iteration, peak device "
            f"memory {peak:.1f} MiB, final loss {model.final_loss_!r}")
    log(f"  a float32 iteration: {per_iter[0]} kernel launches, "
        f"{per_iter[1]} host syncs")


def loss64_gate(label, loss_at_32, loss_64):
    rel = abs(loss_at_32 - loss_64) / abs(loss_64)
    log(f"  float64 loss at the float32 optimum {loss_at_32!r}, at the "
        f"float64 optimum {loss_64!r}: {rel:.3e} relative (rtol "
        f"{MN_LOSS_RTOL})")
    if not rel <= MN_LOSS_RTOL:
        fail(f"{label}: the float32 optimum is off the float64 one")


def run_matnormal_phase(torch, smi, dev="cuda"):
    """Phase 32: ``MatnormalRegression`` with ``CovAR1(600,
    scan_onsets=[0, 300])`` time and ``CovKroneckerFactored([16, 16,
    8], mask=ellipsoid)`` space covariances on planted data
    (``matnormal_data``), fit in float32 and in float64 on the card:
    the float64 loss at the float32 optimum within ``MN_LOSS_RTOL`` of
    the float64 optimum's, corr(beta-hat, beta) over the kept voxels
    above ``MN_BETA_CORR`` (both fits), rho-hat, ``calibrate``'s corr
    with the design; seconds, iterations, peak memory, the launches
    and syncs of an iteration."""
    from brainiak_tpu_torch.matnormal import MatnormalRegression, covs
    from brainiak_tpu_torch.matnormal.utils import place

    mask = mn_ellipsoid()
    X, Y, beta = matnormal_data(SEED + 80)
    log(f"phase 32, MatnormalRegression ({smi}): T={MN_TRS} in runs at "
        f"{MN_ONSETS}, {MN_CONDITIONS} conditions, a {MN_BOX} box with "
        f"{int(mask.sum())} voxels kept, AR(1) rho {MN_RHO} planted")

    def make():
        return MatnormalRegression(
            covs.CovAR1(MN_TRS, scan_onsets=MN_ONSETS),
            covs.CovKroneckerFactored(list(MN_BOX), mask=mask), device=dev)

    fits = {name: mn_fit(torch, make, (X, Y, True), dtype)
            for name, dtype in (("float32", torch.float32),
                                ("float64", torch.float64))}
    mn_report("MatnormalRegression", fits,
              mn_iteration_counts(torch, make, (X, Y, True)))
    m32, m64 = fits["float32"][0], fits["float64"][0]
    x64 = torch.as_tensor(X, dtype=torch.float64, device=dev)
    y64 = torch.as_tensor(Y, dtype=torch.float64, device=dev)
    at32 = place({"beta": m32.beta_, "time": m32.time_params_,
                  "space": m32.space_params_}, torch.float64, dev)
    loss64_gate("phase 32", float(-m64.logp(x64, y64, at32)),
                m64.final_loss_)
    keep = mask
    for name, model in (("float32", m32), ("float64", m64)):
        corr = np.corrcoef(model.beta_[:, keep].ravel(),
                           beta[:, keep].ravel())[0, 1]
        rho = float(2 * torch.sigmoid(model.time_params_["rho_unc"][0]) - 1)
        x_hat = model.calibrate(Y)
        cal = np.corrcoef(x_hat.ravel(), X.ravel())[0, 1]
        log(f"  {name}: corr(beta-hat, beta) {corr:.6f} over the kept "
            f"voxels, rho-hat {rho:.6f}, calibrate's corr with X {cal:.6f}")
        if not corr > MN_BETA_CORR:
            fail(f"phase 32: the {name} fit does not recover beta")
    b32, b64 = m32.beta_[:, keep], m64.beta_[:, keep]
    log(f"  max|beta32 - beta64| / max|beta64| "
        f"{np.abs(b32 - b64).max() / np.abs(b64).max():.3e}")


def run_mnrsa_phase(torch, smi, dev="cuda"):
    """Phase 33: ``MNRSA`` with the same time covariance, a
    ``CovDiagonal(2048)`` space covariance and ``n_nureg=5`` on planted
    data (``mnrsa_data``), fit in float32 and in float64 on the card:
    the float64 loss at the float32 optimum within ``MN_LOSS_RTOL``,
    the off-diagonal corr of ``C_`` with U above ``MNRSA_CORR`` (both
    fits), max|U32 - U64| / max|U64|; seconds, iterations, peak memory,
    the launches and syncs of an iteration."""
    from brainiak_tpu_torch.matnormal import MNRSA, covs
    from brainiak_tpu_torch.matnormal.utils import (flatten_cholesky_unique,
                                                    place)

    X, Y, U = mnrsa_data(SEED + 81)
    log(f"phase 33, MNRSA ({smi}): T={MN_TRS} in runs at {MN_ONSETS}, "
        f"V={MNRSA_VOXELS}, {MN_CONDITIONS} conditions in 4 blocks of 4, "
        f"n_nureg={MNRSA_NUREG}")

    def make():
        return MNRSA(covs.CovAR1(MN_TRS, scan_onsets=MN_ONSETS),
                     covs.CovDiagonal(MNRSA_VOXELS), n_nureg=MNRSA_NUREG,
                     max_iters=MNRSA_ITERS, device=dev)

    fits = {name: mn_fit(torch, make, (Y, X, True), dtype)
            for name, dtype in (("float32", torch.float32),
                                ("float64", torch.float64))}
    mn_report("MNRSA", fits, mn_iteration_counts(torch, make, (Y, X, True)))
    m32, m64 = fits["float32"][0], fits["float64"][0]
    at32 = place({"L_flat": flatten_cholesky_unique(
                      m32.L_.astype(np.float64)),
                  "X_0": m32.X_0_, "time": m32.time_params_,
                  "space": m32.space_params_}, torch.float64, dev)
    x64 = torch.as_tensor(X, dtype=torch.float64, device=dev)
    y64 = torch.as_tensor(Y, dtype=torch.float64, device=dev)
    loss64_gate("phase 33", float(-m64.logp(x64, y64, at32)),
                m64.final_loss_)
    iu = np.triu_indices(MN_CONDITIONS, 1)
    for name, model in (("float32", m32), ("float64", m64)):
        corr = np.corrcoef(model.C_[iu], U[iu])[0, 1]
        log(f"  {name}: off-diagonal corr of C_ with U {corr:.6f}")
        if not corr > MNRSA_CORR:
            fail(f"phase 33: the {name} fit does not recover U's blocks")
    log(f"  max|U32 - U64| / max|U64| "
        f"{np.abs(m32.U_ - m64.U_).max() / np.abs(m64.U_).max():.3e}")


def iem_1d_data(seed):
    """1-D IEM data: orientations on a 1-degree grid in [0, 180), voxels
    a positive mix of the model's 6 channels plus N(0, 0.5) noise."""
    from brainiak_tpu_torch.reconstruct import InvertedEncoding1D

    rng = np.random.RandomState(seed)
    y = rng.randint(0, 180, IEM_TRIALS).astype(float)
    probe = InvertedEncoding1D(n_channels=6, device="cpu")
    probe.channels_, _ = probe._define_channels()
    C = probe._define_trial_activations(y)
    X = C @ rng.rand(IEM_VOXELS, 6).T + 0.5 * rng.randn(IEM_TRIALS,
                                                          IEM_VOXELS)
    return X, y


def iem_2d_model(dev, fwhm=None):
    from brainiak_tpu_torch.reconstruct import InvertedEncoding2D

    model = InvertedEncoding2D([-6, 6], [-5, 5], [121, 101],
                               stim_radius=IEM_RADIUS, device=dev)
    model.define_basis_functions_sqgrid(8, channel_size=fwhm)
    return model


def iem_2d_data(seed):
    """2-D IEM data: disc stimuli of radius ``IEM_RADIUS`` centred
    uniformly over the field of view [-6, 6] x [-5, 5] (so that every
    channel of the grid, the edge ones too, is driven), voxels a
    positive mix of the 8 x 8 channels' responses (scaled to a largest
    response of 1, as the 1-D channels' are) plus N(0, 0.5) noise."""
    rng = np.random.RandomState(seed)
    centers = np.column_stack([rng.uniform(-6, 6, IEM_TRIALS),
                               rng.uniform(-5, 5, IEM_TRIALS)])
    C = iem_2d_model("cpu")._define_trial_activations(centers)
    C = C / C.max()
    X = C @ rng.rand(IEM_VOXELS, C.shape[1]).T + \
        0.5 * rng.randn(IEM_TRIALS, IEM_VOXELS)
    return X, centers


def iem_fit(torch, model, X, y, dtype):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model._fit(X, y, dtype)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def run_iem_phase(torch, smi, dev="cuda"):
    """Phase 34: ``InvertedEncoding1D`` (6 channels, half-circular) and
    ``InvertedEncoding2D`` (an 8 x 8 square grid over [-6, 6] x [-5, 5]
    at 121 x 101 pixels) on 480 trials x 2,000 voxels, trained on 360
    and tested on 120, in float32 and float64 on the card: the median
    held-out error under ``IEM_1D_DEG`` / ``IEM_2D_UNITS``, the float32
    predictions equal to float64's on at least ``IEM_AGREE``; then
    ``fmin`` over the 2-D model's channel FWHM, ``HPO_EVALS``
    evaluations, each a float32 fit and a held-out score on the card."""
    import scipy.stats

    from brainiak_tpu_torch.hyperparamopt import fmin
    from brainiak_tpu_torch.reconstruct import InvertedEncoding1D

    tr, te = slice(0, IEM_TRAIN), slice(IEM_TRAIN, IEM_TRIALS)
    X1, y1 = iem_1d_data(SEED + 82)
    X2, y2 = iem_2d_data(SEED + 83)
    log(f"phase 34, IEM and HPO ({smi}): {IEM_TRIALS} trials x "
        f"{IEM_VOXELS} voxels, {IEM_TRAIN} to train")
    cases = (
        ("InvertedEncoding1D", lambda: InvertedEncoding1D(
            n_channels=6, stimulus_mode='halfcircular', device=dev),
         X1, y1, lambda p, y: np.abs(((p - y) + 90) % 180 - 90),
         IEM_1D_DEG, "degrees"),
        ("InvertedEncoding2D", lambda: iem_2d_model(dev), X2, y2,
         lambda p, y: np.linalg.norm(p - y, axis=1), IEM_2D_UNITS,
         "units"))
    for label, make, X, y, err_of, bar, unit in cases:
        preds = {}
        for name, dtype in (("float32", torch.float32),
                            ("float64", torch.float64)):
            model = make()
            secs = iem_fit(torch, model, X[tr], y[tr], dtype)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds[name] = model.predict(X[te])
            pred_secs = time.perf_counter() - t0
            err = np.median(err_of(preds[name], y[te]))
            log(f"  {label} {name}: fit {secs:.3f} s, predict "
                f"{pred_secs:.3f} s, median held-out error {err:.4f} {unit}")
            if not err < bar:
                fail(f"phase 34: {label} {name} misses its held-out bar")
        same = float(np.mean(np.all(
            np.atleast_2d(preds["float32"].T == preds["float64"].T),
            axis=0)))
        log(f"  {label}: float32 predictions equal to float64's on "
            f"{same:.4f} of the held-out trials")
        if same < IEM_AGREE:
            fail(f"phase 34: {label}'s float32 predictions are off float64")

    # the training discs' pixel masks do not depend on the channels: each
    # evaluation passes its design C = masks @ channelsᵀ to ``fit``
    probe = iem_2d_model("cpu")
    flat_x, flat_y = probe.xp.reshape(-1), probe.yp.reshape(-1)
    masks = (np.sqrt((flat_x[None] - y2[tr, :1]) ** 2 +
                     (flat_y[None] - y2[tr, 1:]) ** 2) <= IEM_RADIUS) * 1.0
    if not np.allclose(masks @ probe.channels.T,
                       probe._define_trial_activations(y2[tr])):
        fail("phase 34: the masks are not the model's")

    def loss(params):
        model = iem_2d_model(dev, params['fwhm'])
        model.fit(X2[tr], y2[tr], C=masks @ model.channels.T)
        return float(np.median(np.linalg.norm(model.predict(X2[te]) - y2[te],
                                              axis=1)))

    np.random.seed(SEED + 84)
    trials = []
    lo, hi = HPO_FWHM
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = fmin(loss, {'fwhm': {'dist': scipy.stats.uniform(lo, hi - lo),
                                'lo': lo, 'hi': hi}},
                max_evals=HPO_EVALS, trials=trials,
                init_random_evals=HPO_RANDOM)
    secs = time.perf_counter() - t0
    log(f"  fmin over the channel FWHM in {HPO_FWHM}: {len(trials)} "
        f"evaluations in {secs:.3f} s ({secs / len(trials):.3f} s each); "
        f"best FWHM {best['fwhm']:.4f}, median held-out error "
        f"{best['loss']:.4f} units (the default FWHM's: "
        f"{loss({'fwhm': None}):.4f})")
    if len(trials) != HPO_EVALS or not best['loss'] < IEM_2D_UNITS:
        fail("phase 34: fmin did not run its evaluations or find a "
             "channel size under the 2-D bar")


SIM_SMALL = (24, 24, 16)   # step 1: the card against the CPU
SIM_SMALL_TRS = 60
SIM_GRID = (64, 64, 36)    # a 3 mm EPI volume, 147,456 voxels
SIM_TRS = 300
SIM_TR = 2.0
SIM_AGREE = 1e-9           # card vs CPU in float64, of max|noise|
SIM_AR_ATOL = 0.15         # calc_noise's AR coefficient against 0.5
SIM_FWHM_RTOL = 0.35       # calc_noise's FWHM against 4 voxels
SIM_DRAWS = ("randn", "normal", "rand", "permutation", "choice")


class SimTally:
    """A context that splits fmrisim runs by the host clock: seconds in
    NumPy's global-stream draws, seconds in ``fmrisim._upload`` (the
    pinned staging copy and the enqueue of the asynchronous copy), the
    stopping-rule readings of each fit loop (``_snr``, ``_sfnr``) and,
    with ``syncs``, the host syncs inside the fit loops under
    ``torch.cuda.set_sync_debug_mode("warn")``.  The wrappers are taken
    off on exit."""

    def __init__(self, torch, sim, syncs=False):
        self.torch, self.sim, self.count_syncs = torch, sim, syncs
        self.draws = self.uploads = 0.0
        self.readings = {"_snr": 0, "_sfnr": 0}
        self.syncs = 0
        self.where = {}
        self.stacks = {}
        self._saved = []

    def _patch(self, owner, name, make):
        inner = getattr(owner, name)
        self._saved.append((owner, name, inner))
        setattr(owner, name, make(inner))

    def _timed(self, field):
        def make(inner):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return inner(*args, **kwargs)
                finally:
                    setattr(self, field, getattr(self, field)
                            + time.perf_counter() - t0)
            return call
        return make

    def _counted(self, name):
        def make(inner):
            def call(*args, **kwargs):
                self.readings[name] += 1
                return inner(*args, **kwargs)
            return call
        return make

    def _synced(self, inner):
        import traceback
        import warnings

        torch = self.torch

        def seen(message, category, filename, lineno, *rest):
            if "synchroniz" not in str(message):
                return
            self.syncs += 1
            at = f"{filename.rpartition('/')[2]}:{lineno}"
            if at not in self.where:
                # the Python stack that led to it, for the log
                self.stacks[at] = " <- ".join(
                    f"{f.filename.rpartition('/')[2]}:{f.lineno} {f.name}"
                    for f in reversed(traceback.extract_stack()[-9:-1]))
            self.where[at] = self.where.get(at, 0) + 1

        def call(*args, **kwargs):
            # switched on outside the recording: turning it on may warn
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("always")
                    warnings.showwarning = seen
                    return inner(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return call

    def __enter__(self):
        for name in SIM_DRAWS:
            self._patch(np.random, name, self._timed("draws"))
        self._patch(self.sim, "_upload", self._timed("uploads"))
        for name in self.readings:
            self._patch(self.sim, name, self._counted(name))
        if self.count_syncs:
            for name in ("_fit_spatial", "_fit_temporal"):
                self._patch(self.sim, name, self._synced)
        return self

    def __exit__(self, *exc):
        for owner, name, inner in reversed(self._saved):
            setattr(owner, name, inner)
        return False


def sim_card_vs_cpu(torch, sim, smi, dev):
    """Phase 35, step 1: matched noise at ``SIM_SMALL`` from one seed on
    the card and on the CPU (within ``SIM_AGREE``, as many fit readings,
    equal calibrated exponents); then ``generate_stream(rng=SEED)`` at
    the default settings on both."""
    from brainiak_tpu_torch.utils.fmrisim_real_time_generator import \
        generate_stream

    dims = np.array(SIM_SMALL)
    runs = {}
    for d in (dev, "cpu"):
        mask, template = sim.mask_brain(dims, mask_self=False, device=d)
        np.random.seed(SEED + 81)
        with SimTally(torch, sim) as tally:
            noise = sim.generate_noise(dims, np.zeros((SIM_SMALL_TRS, 1)),
                                       SIM_TR, template, mask,
                                       {'matched': 1}, device=d)
        runs[d] = (noise.cpu().numpy(), dict(tally.readings))
    (card, card_reads), (host, host_reads) = runs[dev], runs["cpu"]
    err = float(np.abs(card - host).max() / np.abs(host).max())
    key = (tuple(SIM_SMALL), 4.0)
    exps = [sim._SPECTRAL_CALIBRATION[key + (torch.device(d).type,)]
            for d in (dev, "cpu")]
    log(f"  step 1 ({smi}): generate_noise {SIM_SMALL} x {SIM_SMALL_TRS} "
        f"TRs, matched, card vs CPU max|d| / max|noise| {err:.3e}; fit "
        f"readings (SNR, SFNR) card {card_reads['_snr']}, "
        f"{card_reads['_sfnr']}, CPU {host_reads['_snr']}, "
        f"{host_reads['_sfnr']}; calibrated exponent card {exps[0]!r}, "
        f"CPU {exps[1]!r}")
    if not err <= SIM_AGREE:
        fail("phase 35: the card's noise is off the CPU's")
    if card_reads != host_reads:
        fail("phase 35: the fit loops ran a different number of "
             "iterations on the card")
    if exps[0] != exps[1]:
        fail("phase 35: the calibrated exponents differ")
    t0 = time.perf_counter()
    card = generate_stream(rng=SEED, device=dev)
    t_card = time.perf_counter() - t0
    host = generate_stream(rng=SEED, device="cpu")
    err = float(np.abs(card.brain - host.brain).max()
                / np.abs(host.brain).max())
    same = all(np.array_equal(getattr(card, n), getattr(host, n))
               for n in ("mask", "roi_a", "roi_b", "labels"))
    log(f"  step 1 ({smi}): generate_stream(rng={SEED}) {card.brain.shape}"
        f" in {t_card:.3f} s on the card, card vs CPU max|d| / max|brain| "
        f"{err:.3e}, mask, ROIs and labels equal: {same}")
    if not err <= SIM_AGREE or not same:
        fail("phase 35: the card's stream is off the CPU's")


def run_fmrisim_phase(torch, smi, dev="cuda"):
    """Phase 35, the fMRI simulator (``utils/fmrisim.py`` and its
    real-time generator; no kernel).  Step 1, :func:`sim_card_vs_cpu`.
    Step 2, ``generate_noise`` at ``SIM_GRID`` x ``SIM_TRS`` TRs, TR
    ``SIM_TR``, matched, drift_sigma 1, AR 0.5, MA 0, the default SFNR
    90 and SNR 50, on the packaged template: noise >= 0, the brain's
    mean over 10 times the rest's, the port's SNR and SFNR of it within
    0.3x-3x of their targets; ``calc_noise`` of it: the AR coefficient
    within ``SIM_AR_ATOL`` of 0.5, the FWHM within ``SIM_FWHM_RTOL`` of
    4.  Its seconds split into host draws, uploads and the rest (the
    enqueue of the device work and the waits on it), the fit loops'
    readings and host syncs, peak device memory; then one profiled
    temporal fit iteration's body (temporal and system noise redrawn
    and combined): device busy time and launches."""
    from torch.profiler import ProfilerActivity, profile

    from brainiak_tpu_torch.utils import fmrisim as sim

    log(f"phase 35, the fMRI simulator ({smi})")
    sim_card_vs_cpu(torch, sim, smi, dev)

    grid = np.array(SIM_GRID)
    mask, template = sim.mask_brain(grid, mask_self=False, device=dev)
    noise_dict = {'drift_sigma': 1, 'auto_reg_rho': [0.5],
                  'ma_rho': [0.0], 'matched': 1}
    stim = np.zeros((SIM_TRS, 1))
    np.random.seed(SEED + 85)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with SimTally(torch, sim, syncs=True) as tally:
        t0 = time.perf_counter()
        noise = sim.generate_noise(grid, stim, SIM_TR, template, mask,
                                   noise_dict, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reads = tally.readings["_snr"] + tally.readings["_sfnr"]
    log(f"  step 2 ({smi}): generate_noise {SIM_GRID} x {SIM_TRS} TRs "
        f"(matched, drift 1, AR 0.5): {wall:.3f} s = host draws "
        f"{tally.draws:.3f} + uploads {tally.uploads:.3f} + the rest "
        f"{wall - tally.draws - tally.uploads:.3f}; fit readings SNR "
        f"{tally.readings['_snr']}, SFNR {tally.readings['_sfnr']}; host "
        f"syncs in the fit loops {tally.syncs} "
        f"({tally.syncs / max(reads, 1):.2f} a reading, at {tally.where}); "
        f"peak device memory {peak:.3f} GiB")
    if tally.syncs != reads:
        for at, stack in tally.stacks.items():
            log(f"    sync at {at}: {stack}")
        fail("phase 35: a fit iteration synced more than once")
    inside = mask > 0
    brain = float(noise[inside].mean())
    rest = float(noise[~inside].mean())
    snr = sim._calc_snr(noise, mask, device=dev)
    sfnr = sim._calc_sfnr(noise, mask, device=dev)
    log(f"  step 2 ({smi}): min {float(noise.min()):.6f}, brain mean "
        f"{brain:.4f}, non-brain mean {rest:.4f}; SNR {snr:.4f} "
        f"(target 50), SFNR {sfnr:.4f} (target 90)")
    if float(noise.min()) < 0 or not brain > 10 * rest:
        fail("phase 35: the noise has negative values or no brain")
    if not (0.3 * 50 < snr < 3 * 50 and 0.3 * 90 < sfnr < 3 * 90):
        fail("phase 35: the SNR or SFNR is off its target")

    np.random.seed(SEED + 86)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = sim.calc_noise(noise, mask, template, device=dev)
    secs = time.perf_counter() - t0
    log(f"  step 2 ({smi}): calc_noise in {secs:.3f} s: AR "
        f"{est['auto_reg_rho'][0]:.6f}, MA {est['ma_rho'][0]:.6f}, FWHM "
        f"{est['fwhm']:.6f}, SFNR {est['sfnr']:.4f}, SNR {est['snr']:.4f}, "
        f"max activity {est['max_activity']:.4f}")
    if abs(est['auto_reg_rho'][0] - 0.5) > SIM_AR_ATOL or \
            abs(est['fwhm'] - 4) > SIM_FWHM_RTOL * 4:
        fail("phase 35: calc_noise does not recover the AR coefficient "
             "or the FWHM")
    del noise

    full = sim._noise_dict_update(dict(noise_dict))
    brain_mask = sim._Mask(mask)
    base = template * full['max_activity']
    drift = torch.zeros(SIM_TRS, dtype=torch.float64, device=dev)
    dims_tr = tuple(SIM_GRID) + (SIM_TRS,)

    def temporal_iteration():
        noise_temporal = sim._generate_noise_temporal(
            stim, SIM_TR, dims_tr, None, brain_mask, full, device=dev)
        system = sim._generate_noise_system(dims_tr, 1.0, 1.0, device=dev)
        return sim._combine(base, drift, system, noise_temporal, 1.0)

    temporal_iteration()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        temporal_iteration()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted(((us, n, name) for name, (us, n)
                      in device_events(torch, prof)), reverse=True)
    host, _ = launch_counts(torch, prof)
    busy = sum(us for us, _, _ in kernels) / 1e3
    log(f"  a temporal fit iteration's body ({smi}): {wall_ms:.3f} ms "
        f"(profiled), device busy {busy:.3f} ms, {host} host launches")
    for us, n, name in kernels[:5]:
        log(f"    {us / 1e3:9.3f} ms {n:6d}x {name[:80]}")


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
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}")
    smi = nvidia_smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name in sorted(built):
        for row in ptxas_summary(built[name][1]):
            log(f"  {row}")

    rows = phase_kernels(torch, dev)
    rows.update(phase_mesh_kernels(torch, dev))
    torch.cuda.empty_cache()

    # main path, whole brain (two masks)
    rng = np.random.default_rng(SEED + 1)
    images, conditions, mask1 = whole_brain_inputs(rng)
    shape = mask1.shape
    prep_records = []
    vs, accs, launches, wb_results = run_path(
        torch, "whole brain", images, conditions, mask1,
        np.ones(shape, dtype=bool), 4, 256, prep_records)
    # kept for the file front end, which reads them back from files
    wb_inputs = (images, conditions, mask1)
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
    run_obs_cost(torch, vs, prep_records, smi)
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

    # phases 20-22, FCMA on a mesh, on the whole-brain inputs
    t0 = time.perf_counter()
    rows["fcma_gram_mesh"]["launches"], ref_grams, mesh_accs = \
        run_mesh_selection(torch, vs, accs)
    rows["fcma_gram_distla"]["launches"] = run_distla_selection(
        torch, vs, accs, ref_grams, a256)
    del ref_grams
    run_two_ranks(torch, mesh_accs)
    log(f"phases 20-22 ({smi}): {time.perf_counter() - t0:.1f} s")
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
    _, _, launches, _ = run_path(torch, "one mask", images, conditions,
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
    run_fit_contract(torch, smi)
    run_srm_contract(torch, smi)
    # phase 14's data, kept for RSRM and FastSRM (phases 17 and 19)
    srm_phase_data = srm_data(SRM_SUBJECTS, SRM_VOXELS, SRM_TRS,
                              SRM_FEATURES, SEED + 7)
    # the single-process fits that phase 23's two ranks are held to
    single_fits = {}
    run_srm(torch, smi, data=srm_phase_data, keep=single_fits)
    run_panel_gram(torch, smi)
    run_file_front_end(torch, *wb_inputs, wb_results, smi)
    del wb_inputs
    for label, phase in (
            ("17, RSRM", lambda: (run_rsrm_contract(torch, smi),
                                  run_rsrm(torch, smi,
                                           data=srm_phase_data,
                                           keep=single_fits))),
            ("18, SS-SRM", lambda: run_sssrm(torch, smi)),
            ("19, FastSRM", lambda: run_fastsrm(torch, smi,
                                                data=srm_phase_data))):
        t0 = time.perf_counter()
        phase()
        log(f"phase {label} ({smi}): {time.perf_counter() - t0:.1f} s")
    del srm_phase_data
    torch.cuda.empty_cache()
    htfa_ranks = []
    for label, phase in (
            ("23, two ranks over gloo", lambda: htfa_ranks.extend(
                run_gloo_ranks(torch, smi, single_fits, mesh_accs, rows))),
            ("24, searchlight", lambda: run_searchlight_phase(torch, smi)),
            ("25, MVPA voxel selection", lambda: run_mvpa_phase(torch,
                                                                smi))):
        t0 = time.perf_counter()
        phase()
        log(f"phase {label} ({smi}): {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    del single_fits
    for label, phase in (
            ("27, resampling nulls", lambda: run_stats_phase(torch, smi)),
            ("28, event segmentation", lambda: run_eventseg_phase(torch,
                                                                 smi)),
            ("29, TFA", lambda: run_tfa_phase(torch, smi)),
            ("30, HTFA", lambda: run_htfa_phase(torch, smi, htfa_ranks)),
            ("31, the encoding tier", lambda: run_encoding_phase(
                torch, smi, rows)),
            ("32, MatnormalRegression", lambda: run_matnormal_phase(torch,
                                                                    smi)),
            ("33, MNRSA", lambda: run_mnrsa_phase(torch, smi)),
            ("34, IEM and HPO", lambda: run_iem_phase(torch, smi)),
            ("35, the fMRI simulator", lambda: run_fmrisim_phase(torch,
                                                                 smi))):
        t0 = time.perf_counter()
        phase()
        log(f"phase {label} ({smi}): {time.perf_counter() - t0:.1f} s")
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
        "fcma_gram_mesh": k1_tc, "fcma_gram_distla": k1_tc,
        "fcma_gram_rank": k1_tc,
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
                  ring_mma_v4096=k5_tc, ring_mma_ridge=k5_tc,
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
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all, "
        f"the build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
