"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile OUT_DIR | --ab OLD_CSRC_DIR]

Run from the root of the repository on a machine with an NVIDIA H100 and the
CUDA toolkit. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's five CUDA kernels from `eigentrajectory_tpu_torch/ops/csrc`
   (one nvcc each, started together) and prints their ptxas register and
   spill lines;
3. holds each kernel against its plain PyTorch version on the card
   (atol = rtol = 1e-4: the sums run in another order):
   `fused_recon_metrics` at the eval shape (k=6, S=20, T=12, N=320*57), at a
   ragged N, and on a case with sca == 0, an FDE tie and a constant-GT
   pedestrian; `fused_reconstruct` at the serving shape (N=301*128), at a
   ragged N, and on the sca == 0 case, which must reconstruct exactly to its
   origin; both at the edges of the kernels' 32-pedestrian tile (N = 1, 31,
   32, 33 and 109) with a mixed, an all-moving and an all-static mask; and
   on every case the two kernels must give the same trajectories bit for bit;
   after step 4's test(), `fused_col` (within 1e-5: COL counts samples) on
   the inputs of ET-STGCNN's test() of the 320 x 57 block, on a block of
   dense scenes (57 walkers a row), on rows of 500 slots (past a block's
   threads and its 48 KB of shared memory), with NaN futures, and on the
   packed layout through a gather map;
4. drives the eval path, `ETTorchTrainer.test()`, of ET-STGCNN (hotel
   configuration, committed hotel checkpoint) and of ET-SGCN (zara1, committed
   zara1 checkpoint) on a synthetic test split sized like hotel's (301
   scenes, ~1,050 pedestrians) in one padded block of 320 x 57 slots; checks
   that `fused_recon_metrics` ran, that the metrics are finite, and that the
   same run on the CPU agrees within 1e-4;
5. drives the serving path, `ETPredictor.predict()`, of both models from the
   same checkpoints on three requests: (a) one scene of 5 pedestrians, (b)
   the whole synthetic split in one request with its scene ids (301 scenes
   in 128-slot rows), (c) one scene of 150 pedestrians (256 slots). Each
   request checks that `fused_reconstruct` ran once, on exactly the request's
   pedestrians (not the padded slots), that the futures are finite,
   and that the card is as close to the exact answer (a float64 run of the
   same code on the CPU) as the CPU's own float32 run, within 1e-4 more; on
   (a) and (b) the card must also agree with the CPU's float32 run within
   1e-4, and on (a) a scene predicted alone must equal its rows in a
   two-scene request;
6. times both kernels beside the least time the card could take for their
   work. `ms`/`kernel_ms` is device time at a cold cache: a run of launches
   captured into a CUDA graph, so that no Python runs in the window, each on
   another of several input sets and into an output of its own, so that
   consecutive launches touch more than twice the 50 MB L2, replayed between
   two CUDA events. `warm_ms` is the same with one input set (L2-warm), and
   `call_ms` a loop of calls of the Python wrapper on one input set between
   two events, which holds the host's share. `output_fill_ms` is what a
   PyTorch zero_() of the same outputs alone takes by the cold method. The
   plain versions are timed by a loop of calls; test() and predict()
   (request (b)) on the host clock. `fused_col` is timed the same way at
   the main path's inputs and at the dense block, each beside its bound;
7. drives the training path of ET-STGCNN (hotel configuration, batch 128 x
   N_max 57) on synthetic splits of 1,301 train scenes (11 steps an epoch,
   the last block with 21 real scenes and 107 padding rows), 301 val and the
   301 test scenes, into a temporary checkpoint directory:
   `init_descriptor()` on the card against a CPU fit (bases orthonormal and
   equal within 1e-5, anchors' inertia within 1%); one step's loss,
   gradients and BN statistics on the card against the CPU in float32 and
   float64, on the epoch's first block and on its padded last block (loss
   within 1e-5 relative, every gradient tensor as close to the float64 one
   as the CPU's float32 is, within 1e-4 of that tensor's largest entry more
   (at least a thousandth of the largest entry of any gradient tensor, for
   the tensors whose true gradient is 0), BN statistics within 1e-5); `fit(3)` (losses finite, the third epoch's
   train loss below the first's, `model_best.msgpack` written); `load_model()`
   and `test()`, which must launch `fused_recon_metrics` once a block and
   give a fresh trainer that loads the checkpoint exactly the same means;
   `fit(resume=True)` from the state written after epoch 2, which must run
   epoch 3 only. Then ET-SGCN (zara1 configuration): `init_descriptor()`,
   one epoch, `test()`. It prints the median train-step time (host clock, a
   synchronize at each end) over the steps of epochs 2-3, the epoch seconds,
   trained trajectories per second, the seconds of `init_descriptor()` split
   into the basis fit (host SVD) and k-means, and where a step's time goes
   (to_device, forward, backward, optimizer by CUDA events and by the host
   clock; the loss's einsum reconstruction alone);
8. drives the collated regime on splits of scenes of 2-20 pedestrians
   (test 301 scenes / 3,351 pedestrians, train 1,301, val 301): both kernels
   against their plain versions at the packed eval's N = P = 2,067 (64 full
   tiles and 19 more); ET-PECNet (pecnet-univ configuration, committed univ
   checkpoint) `test()` with `eval_ped_batch` 2048, which must launch
   `fused_recon_metrics` once a packed batch (2) at N = P, with finite means
   that agree with the CPU's within 1e-4; `predict()` of requests (a), (b)
   and (c) as in step 5 (card vs the CPU's float64 run; (a) and (b) also
   against its float32 run); host-clock medians of that test() and predict()
   (b); ET-PECNet training packing 128 pedestrians into p_max = 147 slots:
   `init_descriptor()` card vs CPU, one step's loss and gradients card vs CPU
   float32 and float64 on the first packed batch, `fit(2)`, `load_model()` +
   `test()` (launches as above; a fresh trainer on the written checkpoint
   gives the same means exactly), the train-step median, epoch seconds,
   trained trajectories per second and `init_descriptor()` seconds; then
   ET-LB-EBM (lbebm-univ, random weights): `init_descriptor()`, one epoch,
   `test()` and `predict()` (b), each launching its kernel, with finite
   results;
9. drives ET-AgentFormer (agentformer-zara2 configuration, committed zara2
   checkpoint; model width 256, 8 heads, 2 + 2 layers) on the splits of
   step 8: `test()` at the model's packed cap of 128 pedestrians (26 batches
   of P = 147 slots, 1,176 encoder tokens), which must launch
   `fused_recon_metrics` once a batch at N = P, card vs CPU within 1e-4 on
   every mean; `predict()` (a), (b), (c) at 32 slots a scene, each card vs
   the CPU's float32 (within 1e-4) and float64 runs, with the peak device
   memory of (b); host-clock medians of that test() and predict() (b);
   9b: the agent-aware attention kernel (`agent_attention`) against its plain
   version (within 1e-4) in its three kinds (encoder, the decoder's causal
   self-attention, cross-attention) at the serve cell's mean request (158
   rows of 32 slots), at the packed row of 147 slots with scene ids and
   with an -inf agent mask; its cold and warm device ms, wrapper-loop ms,
   plain ms and f32 bound at the request and at the packed row, each kind
   and a forward's six attentions; the peak device memory of request (b)
   at 32 and at 128 slots a scene (the futures within 1e-5 of each other);
   training packing 128 pedestrians into 147 slots: `init_descriptor()` card
   vs CPU, one step's loss and gradients with dropout off card vs CPU f32 vs
   f64, `fit(2)` with dropout (the trainer's own stream), `fit(1)` +
   `resume.pt` + `fit(2)` equal to the straight run within 1e-6 relative
   with the dropout generator in the same state, `load_model()` + `test()`
   (a fresh trainer gives the same means exactly); then the reference
   import: ET-SGCN's `model_best.pth` from
   `benchmarks/ref_resume/sgcn-zara1.pt` through
   `interop.import_checkpoint_to_trainer`, its `test()` card vs CPU;
10. drives ET-DMRGCN and ET-Graph-TERN (configurations
   eigentrajectory-{dmrgcn,graphtern}-eth.json at their published widths)
   on the sequenced splits of steps 4 and 7: each imports the reference's
   `model_best.pth` from `benchmarks/ref_resume/<model>-eth.pt` through
   `interop.import_checkpoint_to_trainer`; `test()` launches
   `fused_recon_metrics` once for its block at N = 18,240, card vs CPU
   within 1e-4 on every mean; `predict()` (a), (b), (c) at 128 slots a
   scene against the CPU's float64 run ((a) and (b) also against its
   float32 run within 1e-4); host-clock medians of that test() and predict()
   (b); `init_descriptor()` card vs CPU; one step's loss and gradients with
   DropEdge on, the same masks on the three devices (drawn once on the CPU),
   card vs CPU f32 vs f64 on the epoch's first and padded last block. Then
   ET-DMRGCN `fit(2)`, `fit(1)` + `resume.pt` + `fit(2)` equal to the
   straight run within 1e-6 relative with the dropout generator in the same
   state, `load_model()` + `test()` (a fresh trainer gives the same means
   exactly), the train step by parts; ET-Graph-TERN one epoch and `test()`.
   A failed card-vs-CPU check of ET-DMRGCN prints how many adjacency entries
   of the case lie within 4 ulps of a band edge;
11. groups and zones: drives ET-GP-Graph-STGCNN, ET-GP-Graph-SGCN and
   ET-Social-Implicit (configurations eigentrajectory-<model>-hotel.json at
   their published widths, micro_batches 4, 8 and 1) from the seed's
   weights on the sequenced splits: `init_descriptor()` card vs CPU; GP-Graph's
   th set midway between two adjacent pair distances at the 0.3 quantile of
   the test block's (groups form, no distance within rounding of th);
   Implicit's global_w and local_w drawn in [0.5, 1.5] (the init's 0 gives
   the cells' convs no gradient); one step card vs CPU f32 vs f64 on the
   epoch's first block and on a block of dense scenes (2-57 pedestrians a
   scene; GP-Graph-SGCN on their first 32 rows), `group_cnn`'s gradient NaN
   on every run, Implicit's cell convs learning in the zones used and in no
   other; `fit(1)`, which must launch `group_relabel` once a chunk and
   a val block; th set again after training; `test()` of one block of
   EVAL_BATCH x N_MAX slots and of the dense block, card vs CPU within 1e-4,
   with the group counts (GP-Graph: pedestrians, groups, groups of two or
   more, singletons) or the zone counts (Implicit: two or more used) of the
   block; `predict()` (a), (b), (c) as in step 10 (GP-Graph-SGCN's request
   (b) checked on its first 64 scenes, each a row of its own), each GP-Graph request
   launching `group_relabel` once; peak memory and host-clock medians of `test()` and
   `predict()` (b); for ET-GP-Graph-STGCNN `fit(1)` + `resume.pt` + `fit(2)`
   against `fit(2)` within 1e-4 relative (the card's reductions are not
   bitwise from run to run, and the adjacency amplifies them); ET-DMRGCN (eth weights) `test()`
   and a step with DropEdge on, on the dense block, card vs CPU. Then
   `group_relabel` is held bit for bit against its plain version on the
   masks of the main path at (320, 57), (301, 128) and request (c)'s
   (1, 256), on random masks at N = 31, 32, 33, 1,025 and at the kernel's
   tier edges 64, 65, 128, 129, 256, 257, and on all-merge masks (every
   valid pair merges: the longest chain) at (4, 57) and (1, 256); it is
   timed at the three main-path shapes and on the two all-merge masks, its
   chain depth (rows holding a merge) printed beside the pairs' serial
   depth N(N-1)/2 and rows + merges. A failed card-vs-CPU check of these
   models prints the count of pair distances within 4 ulps of th (or of
   |c_0| within 4 ulps of a bin edge) in the case;
12. data parallelism: spawns DP_WORLD = 2 ranks, NCCL with a card each
   where the machine has two, else both on cuda:0 with gloo (printed:
   collectives go through the host, every kernel and model op runs on the
   card), and runs the same path at world 1 in this process: ET-STGCNN
   (hotel checkpoint) `test()` of the 320 x 57 block (fused_recon_metrics
   once a rank, means within rtol 1e-5 / atol 1e-6), one step on the first
   128 x 57 block and on the last (21 real scenes; the second rank holds
   padding alone), ET-PECNet (univ checkpoint) one step on a packed batch
   split by scenes, ET-DMRGCN one step with DropEdge on, ET-GP-Graph-STGCNN
   one step at micro_batches 4 (th midway between two pair distances,
   group_cnn's gradient NaN on both), ET-AgentFormer (zara2 checkpoint,
   dropout on) one step on the first packed batch of the collated splits
   at batch_size 128 (147 slots, 74 a rank: each rank's queries are its
   slots' tokens, each attention gathers every rank's keys). Each
   sequenced step is held to world 1 running the block in the chunks the
   ranks hold (micro_batches x 2, the same arithmetic; the distance of
   both from the block in one piece is printed), the collated ones to
   world 1 on the whole batch: loss within 1e-5 relative, gradients within
   5e-5 global relative L2 and rtol 2e-3 / atol 1e-5, NaN where NaN, BN statistics
   within 1e-6 of their scale (at least 1), DropEdge masks and the dropout
   stream bitwise, every rank the same step. For ET-AgentFormer it prints
   each rank's and world 1's six attention score shapes (query x key
   tokens; a rank's rows must be T x 74 and add up to world 1's), the
   step's peak device memory (max_memory_allocated) a rank and at world 1,
   the `train.all_gather` spans of a profiled step (13 a rank: 7 gathers
   forward, 6 all-reduces backward; none at world 1) with the profiled
   step's wall and kernel device ms, one gather of the encoder's keys alone
   (forward, and forward + backward) and the step's median ms at world 1
   and 2. `fit(2)` train losses within
   2e-3 relative of world 1, and `fit(1)` + resume to 2 within 1e-5 of the
   straight run (not bitwise on the card); the step's median time at world
   1 and 2 and `test()`'s wall. Then `predict()` request (b) through
   `ETPredictor(mesh=)` over every visible card and over cuda:0 named
   twice, within 1e-5 of `mesh=None`, fused_reconstruct once a replica; and
   the NCCL branch of the process-group helpers in a group of one (the
   all-reduce, a broadcast, a barrier and `all_gather_rows` forward and
   backward on the card);
13. the native loader on the main path, the dormant modules and the
   analysis tools: writes seeded train/val/test split files in the ETH-UCY
   text format (about 300 scenes and 1,150 pedestrians each, the size of
   hotel's test split) and loads the test split with the native C++
   preprocessor (built by g++ into the port's `_build/`) and with the
   Python loader, bitwise equal, both walls printed; builds ET-STGCNN's
   trainer (hotel configuration and checkpoint) from those files, which
   must go through the native loader, and runs `test()`, which must launch
   `fused_recon_metrics` once a block, card vs CPU and vs the same windows
   handed in memory within 1e-4; then, card vs CPU in float32 from the
   port's seeded init with every draw injected or from a seeded generator:
   `PECNetCVAE` (both branches), `LBEBMCVAE` (train branch, Langevin noise
   off) and its sampler alone (its ms for 20 steps printed), the full
   `SocialImplicit`, `GraphTERNFull` with an injected endpoint set (all
   within 1e-4 of scale), `GraphTERNFull` with pruning on the card (each
   selected round one of the rounds drawn), `gmm_endpoint_sample` at a
   near-zero std and one-hot pi (the chosen means), `batch_kmeans_fit` on
   B = 8 problems (inertia within 1%), `compute_all` (within 1e-5) and
   `col_scene_masked` (COL equal); `descriptor_evaluation.eval_dataset` on
   the split files card vs CPU (within 1e-5); and a trainer that fits 2
   epochs, then a fresh one whose `load_model()` must restore the loss log
   the file holds. It prints each check's largest error;
14. prints a JSON line with the four kernels' numbers (the launches of
   every path, step 12's ranks' and step 13's included; `fused_col`'s every
   launch of the run but its own checks' and timings', the host-clock loops
   of test() included), then as its last
   line {"ok": true, "device": {...}}.

`--profile OUT_DIR` also profiles one test() and one predict() of each model
(ET-PECNet's, ET-AgentFormer's, ET-DMRGCN's, ET-Graph-TERN's and step 11's
included, with the span `eval.col` of `fused_col` and
`gpgraph.group_relabel`) and one training epoch of ET-STGCNN, ET-PECNet,
ET-AgentFormer, ET-DMRGCN and the three models of step 11 with
torch.profiler, writes the tables to OUT_DIR/profile_<run>.txt and prints the
device time of each span. `--ab OLD_CSRC_DIR` does steps 1 and 2, then
builds the sources of the same names in OLD_CSRC_DIR (another version of the
kernels, with the same C interface; a kernel whose source the directory
lacks is left out), times both versions of each kernel in turns (old, new,
new, old) by the three methods of step 6 (`group_relabel` by graph replay
and the wrapper loop, on its main-path inputs at (320, 57), (301, 128) and
(1, 256) from ET-GP-Graph-STGCNN's seeded init, th set as in step 11), checks
that the two versions' outputs are the same bits, prints the times and
stops. Any failure raises and the exit code is not 0; without a
CUDA device the script fails before it prints a result.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT_DIR = os.path.join(REPO, "checkpoints")
MODELS = (("stgcnn", "eigentrajectory-stgcnn-hotel.json"),
          ("sgcn", "eigentrajectory-sgcn-zara1.json"))
ATOL = RTOL = 1e-4
K, S, T = 6, 20, 12
EVAL_BATCH, N_MAX = 320, 57            # one padded block, as bench.py times it
N_MAIN = EVAL_BATCH * N_MAX
BUCKET = 128                           # ETPredictor's default slots per scene
N_SCENES = 301
N_SERVE = N_SCENES * BUCKET            # flat slots of request (b)
TILE = 32                              # pedestrians of a block in both kernels
EDGE_NS = (1, TILE - 1, TILE, TILE + 1, 3 * TILE + 13)
# Input sets a cold-cache timing rotates through, and launches in its graph:
# consecutive launches touch more than twice the 50 MB L2 before a set returns.
COLD_SETS_EVAL, COLD_SETS_SERVE = 5, 3
GRAPH_LAUNCHES_EVAL, GRAPH_LAUNCHES_SERVE = 20, 15
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 rate and f32
# rate outside the tensor cores, at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
TRAIN_SCENES, TRAIN_BATCH, TRAIN_EPOCHS = 1301, 128, 3
# The collated phase: ET-PECNet (univ checkpoint) and ET-LB-EBM on splits of
# scenes of 2-20 pedestrians, packed to EVAL_PED_BATCH pedestrians in test()
# (P = 2,067 slots) and to TRAIN_BATCH in training (p_max = 147).
COLLATED_MODELS = (("pecnet", "eigentrajectory-pecnet-univ.json"),
                   ("lbebm", "eigentrajectory-lbebm-univ.json"))
COLLATED_MAX_PEDS, EVAL_PED_BATCH, COLLATED_EPOCHS = 20, 2048, 2
# ET-AgentFormer (zara2 checkpoint) on the collated splits: test() packs to the
# model's cap of 128 pedestrians (P = 147 slots); predict() pads each scene to
# AF_BUCKET slots, the serve cell's (step 9b also serves request (b) at BUCKET).
AGENTFORMER_CFG, AF_BUCKET, AF_EPOCHS = "eigentrajectory-agentformer-zara2.json", 32, 2
# Its attention kernel, timed at the serve cell's mean request (158.5 scenes
# a request at AF_BUCKET slots) and at the packed test() row: each kind's
# (query steps, key steps, causal); a forward runs two of each.
ATTN_KINDS = {"encoder": (8, 8, False), "decoder_self": (6, 6, True), "cross": (6, 8, False)}
ATTN_WIDTH, ATTN_HEADS = 256, 8
ATTN_SERVE_ROWS, ATTN_PACKED_SLOTS, ATTN_LAUNCHES = 158, 147, 10
# Step 10: ET-DMRGCN and ET-Graph-TERN (eth configurations, the reference's
# eth weights) on the sequenced splits; ET-DMRGCN trains MULTIREL_EPOCHS.
MULTIREL_MODELS, MULTIREL_EPOCHS = ("dmrgcn", "graphtern"), 2
# Step 11: ET-GP-Graph-STGCNN, ET-GP-Graph-SGCN and ET-Social-Implicit (hotel
# configurations) from the seeded init on the sequenced splits.
GROUP_ZONE_MODELS = ("gpgraphstgcnn", "gpgraphsgcn", "implicit")
GROUP_ZONE_RUNS = 10                   # host-clock runs of its test() and predict() (b)
# Each kernel's span in the trainer and the predictor, and a part of its
# name in the profiler's trace.
KERNEL_SPANS = {"gpgraph.group_relabel": "group_relabel_kernel",
                "eval.recon_metrics": "recon_metrics_kernel", "eval.col": "col_kernel",
                "serve.reconstruct": "reconstruct_kernel"}


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _case(n, seed, special=False, mask=None):
    """Kernel inputs as numpy arrays. `special` adds a moving ped with
    sca == 0 (ped 0), a ped whose samples all end at one point so that the
    FDE ties (ped 1) and a constant-GT ped (ped 2). `mask` True or False
    makes every ped moving or static."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ang = rng.normal(size=(n,))
    case = dict(
        c_m=rng.normal(size=(K, n, S)), c_s=rng.normal(size=(K, n, S)),
        u_m=rng.normal(size=(2 * T, K)), u_s=rng.normal(size=(2 * T, K)),
        ori=rng.normal(size=(n, 2)),
        rot=np.stack([np.stack([np.cos(ang), -np.sin(ang)], 1),
                      np.stack([np.sin(ang), np.cos(ang)], 1)], 1),
        sca=2.0 / (0.5 + np.abs(rng.normal(size=(n,)))),
        mask=rng.random(n) > 0.4, gt=rng.normal(size=(n, T, 2)))
    if mask is not None:
        case["mask"][:] = mask
    if special:
        case["mask"][:2] = True
        case["sca"][0] = 0.0
        case["u_m"][-2:, 1:] = 0.0           # the last step depends on c[0] only
        case["u_s"][-2:, 1:] = 0.0
        case["c_m"][0, 1, :] = case["c_m"][0, 1, 0]
        case["gt"][2] = 0.5
    return {k: v if v.dtype == bool else v.astype(np.float32) for k, v in case.items()}


def _on(case, device):
    import torch

    return [torch.from_numpy(case[k]).to(device) for k in
            ("c_m", "c_s", "u_m", "u_s", "ori", "rot", "sca", "mask", "gt")]


def _check_kernel(recon, case, label, quiet=False):
    """fused_recon_metrics vs its plain version on the card; returns the max
    abs error and the kernel's outputs.

    TCC scores the first sample of minimal FDE, so it is compared where that
    sample wins by more than f32 rounding (at a closer race the two versions
    may rightly pick different samples); the tie case is checked on its own.
    """
    import torch

    args = _on(case, "cuda")
    got = recon.fused_recon_metrics(*args)
    want = recon.fused_recon_metrics_plain(*args)
    torch.cuda.synchronize()
    fde = torch.linalg.vector_norm(want[0][:, :, -1] - args[-1][None, :, -1], dim=-1)
    two = fde.topk(2, dim=0, largest=False).values
    clear = (two[1] - two[0]) > 1e-5 * (1.0 + two[0])
    err = 0.0
    for name, g, w in zip(("recon", "ade", "fde", "tcc"), got, want):
        if name == "tcc":
            g, w = g[clear], w[clear]
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL,
                                   msg=lambda m: f"{label} {name}: {m}")
        err = max(err, float((g - w).abs().max()))
    if not quiet:
        print(f"fused_recon_metrics check {label}: N={case['c_m'].shape[1]} "
              f"max_abs_err={err:.3e} (atol=rtol={ATOL}; TCC on {int(clear.sum())} peds "
              f"with a clear best sample)", flush=True)
    return err, got


def _check_reconstruct(recon, case, label, quiet=False):
    """fused_reconstruct vs its plain version on the card; returns the max
    abs error and the kernel's output."""
    import torch

    args = _on(case, "cuda")[:-1]
    got = recon.fused_reconstruct(*args)
    want = recon.fused_reconstruct_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL,
                               msg=lambda m: f"fused_reconstruct {label}: {m}")
    err = float((got - want).abs().max())
    if not quiet:
        print(f"fused_reconstruct check {label}: N={case['c_m'].shape[1]} "
              f"max_abs_err={err:.3e} (atol=rtol={ATOL})", flush=True)
    return err, got


def _check_pair(recon, case, label, quiet=False):
    """Both kernels against their plain versions on one case, and against
    each other: the trajectories must be the same bits. Returns the two max
    abs errors and the two kernels' outputs."""
    import torch

    err, got = _check_kernel(recon, case, label, quiet)
    rerr, rgot = _check_reconstruct(recon, case, label, quiet)
    if not torch.equal(got[0], rgot):
        raise AssertionError(f"{label}: fused_reconstruct and fused_recon_metrics give "
                             f"different trajectories on the same inputs")
    return err, rerr, got, rgot


def _check_edges(recon):
    """Both kernels at the edges of their tile of TILE pedestrians, each N
    with a mixed, an all-moving and an all-static mask; returns the two max
    abs errors."""
    err = rerr = 0.0
    for n in EDGE_NS:
        for mask in (None, True, False):
            e, r, _, _ = _check_pair(recon, _case(n, seed=100 + n, mask=mask),
                                     f"N={n} mask={mask}", quiet=True)
            err, rerr = max(err, e), max(rerr, r)
    print(f"tile edges: N in {EDGE_NS} x (mixed, all-moving, all-static) masks, both kernels "
          f"against their plain versions and bit-equal to each other: max_abs_err "
          f"fused_recon_metrics {err:.3e}, fused_reconstruct {rerr:.3e} "
          f"(atol=rtol={ATOL})", flush=True)
    return err, rerr


def _call_ms(fn, iters):
    """Mean time of a call of fn in a loop of calls between two CUDA events:
    the kernel's time or the host's time to enqueue it through the Python
    wrapper, whichever is longer (inputs L2-warm)."""
    import torch

    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _capture(fn, arg_sets, launches):
    """A CUDA graph of `launches` calls of fn, call i on arg_sets[i % sets].

    With several sets every output stays alive with the graph, so each launch
    writes memory of its own and reads inputs that the launches since their
    last use have pushed out of L2: a cold cache. With one set each output is
    dropped at once and its memory reused: L2-warm. Returns the graph and
    what it must keep alive."""
    import torch

    fn(*arg_sets[0])                       # built and loaded before the capture
    torch.cuda.synchronize()
    keep, graph = [arg_sets], torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            out = fn(*arg_sets[i % len(arg_sets)])
            if len(arg_sets) > 1:
                keep.append(out)
            del out
    return graph, keep


def _capture_fill(outputs):
    """A CUDA graph that fills each of the kernel outputs a cold-cache graph
    kept (a tensor or a tuple of tensors a launch) with zeros, one PyTorch
    fill a tensor: what writing the outputs alone costs on this card, as a
    yardstick beside the bound. It is used nowhere in the port."""
    import torch

    tensors = [t for out in outputs for t in (out if isinstance(out, tuple) else (out,))]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for t in tensors:
            t.zero_()
    return graph, outputs


def _replay_ms(captured, launches, replays=5):
    """Device time of one launch: the graph replayed `replays` times between
    two CUDA events, after two warm-up replays, over all its launches. No
    Python runs inside the window."""
    import torch

    graph = captured[0]
    for _ in range(2):
        graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * launches)


def _timed_kernels(main_case, serve_case):
    """What step 6 and --ab time: (wrapper's name, the case of the table's
    shape, its bound, input sets of a cold-cache timing, launches a graph)."""
    return (("fused_recon_metrics", main_case, _recon_metrics_bound_ms,
             COLD_SETS_EVAL, GRAPH_LAUNCHES_EVAL),
            ("fused_reconstruct", serve_case, _reconstruct_bound_ms,
             COLD_SETS_SERVE, GRAPH_LAUNCHES_SERVE))


def _input_sets(name, case, n_sets):
    """The case and n_sets - 1 more of its size from other seeds, as the
    arguments of wrapper `name` on the card."""
    n = case["c_m"].shape[1]
    sets = [_on(c, "cuda") for c in
            [case] + [_case(n, seed=1000 * i + 50) for i in range(1, n_sets)]]
    return [args[:-1] for args in sets] if name == "fused_reconstruct" else sets


@contextmanager
def _csrc_dir(build, path):
    """Have the wrappers build and load the kernels from the sources in
    `path` instead of the package's."""
    package_dir = build.CSRC_DIR
    build.CSRC_DIR = path
    build._loaded.clear()
    try:
        yield
    finally:
        build.CSRC_DIR = package_dir
        build._loaded.clear()


def _ab(recon, build, old_dir, card, kernels):
    """Both versions of each kernel, the sources in `old_dir` and the
    package's, in turns on this card by the three timing methods."""
    import torch

    out = {}
    for name, case, bound, n_sets, launches in kernels:
        fn = getattr(recon, name)
        sets = _input_sets(name, case, n_sets)
        graphs, results = {}, {}
        dirs = {"old": old_dir, "new": build.CSRC_DIR}
        for version, path in dirs.items():
            with _csrc_dir(build, path):
                result = fn(*sets[0])
                results[version] = result if isinstance(result, tuple) else (result,)
                graphs[version] = (_capture(fn, sets, launches), _capture(fn, sets[:1], launches))
        same = all(torch.equal(a, b) for a, b in zip(results["old"], results["new"]))
        diff = float((results["old"][0] - results["new"][0]).abs().max())
        times = {"cold": [], "warm": [], "call": []}
        for version in ("old", "new", "new", "old"):
            cold, warm = graphs[version]
            times["cold"].append((version, _replay_ms(cold, launches)))
            times["warm"].append((version, _replay_ms(warm, launches)))
            with _csrc_dir(build, dirs[version]):
                times["call"].append((version, _call_ms(lambda: fn(*sets[0]), 50)))
        bound_ms = bound(case)[0]
        out[name] = {"n": case["c_m"].shape[1], "bound_ms": bound_ms,
                     "outputs_bit_equal": same, "max_abs_diff_trajectories": diff,
                     **{f"{k}_ms": [[v, round(t, 5)] for v, t in ts] for k, ts in times.items()}}
        print(f"[{card}] A/B {name} N={out[name]['n']} bound {bound_ms:.4f} ms; device ms at "
              f"a cold cache {times['cold']}, L2-warm {times['warm']}, wrapper loop "
              f"{times['call']}; old and new outputs bit-equal: {same} (max |old - new| of "
              f"the trajectories {diff:.3e})", flush=True)
    print(json.dumps({"ab": out}), flush=True)


def _relabel_main_inputs(card):
    """--ab: the relabel's inputs on the main path at (320, 57), (301, 128)
    and request (c)'s (1, 256): ET-GP-Graph-STGCNN (hotel configuration,
    the seed's weights, th set as step 11 sets it) through test() of the
    320 x 57 block and predict() of requests (b) and (c) on the card; and
    the all-merge masks at (4, 57) and (1, 256), step 11's worst case."""
    import numpy as np
    from eigentrajectory_tpu_torch.config import load_config
    from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
    from eigentrajectory_tpu_torch.inference import ETPredictor
    from eigentrajectory_tpu_torch.models import gpgraph_common
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    splits = _sequenced_splits(make_synthetic_data(n_scenes=N_SCENES, max_peds=5, seed=0))
    test = splits[2]
    cfg = load_config(os.path.join(REPO, "configs", "eigentrajectory-gpgraphstgcnn-hotel.json"),
                      checkpoint_dir=CKPT_DIR, n_max_peds=N_MAX)
    tr = ETTorchTrainer(cfg, tag="ab", datasets=splits)
    tr.init_descriptor()
    tr_cpu = ETTorchTrainer(cfg, tag="ab-cpu", datasets=splits, device="cpu")
    tr_cpu.model.load_state_dict(tr.model.state_dict())
    tr_cpu._set_et(tr.et)
    _set_th(tr, tr_cpu, splits, card)
    predictor = ETPredictor(tr, bucket=BUCKET)
    with _noting_relabels(gpgraph_common) as seen:
        tr.test(eval_batch=EVAL_BATCH)
        predictor.predict(test.obs_traj, np.repeat(np.arange(N_SCENES), test.num_peds_in_seq))
        predictor.predict(_walkers(150, seed=13), np.zeros(150, np.int64))
    noted = {}
    for merge, valid, _, _ in seen:
        noted.setdefault(tuple(valid.shape), (merge, valid))
    inputs = {f"{b}x{n}": noted[(b, n)] for b, n in ((EVAL_BATCH, N_MAX), (N_SCENES, BUCKET),
                                                     (1, 2 * BUCKET))}
    inputs.update({f"all_merge_at_{b}x{n}": _all_merge(gpgraph_common, b, n)
                   for b, n in ((4, N_MAX), (1, 2 * BUCKET))})
    return inputs


def _ab_relabel(group, build, old_dir, card, noted):
    """Both versions of the relabel kernel, the source in `old_dir` and the
    package's, on the inputs `_relabel_main_inputs` gives, in turns (old,
    new, new, old):
    device ms by CUDA graph replay (as `_relabel_times`) and the wrapper
    loop's ms; the two versions' outputs must be the same bits."""
    import torch

    out = {}
    dirs = {"old": old_dir, "new": build.CSRC_DIR}
    for key, (merge, valid) in noted.items():
        b, n = valid.shape
        graphs, results = {}, {}
        for version, path in dirs.items():
            with _csrc_dir(build, path):
                results[version] = group.group_ranks(merge, valid)
                graphs[version] = _capture(group.group_ranks, [(merge, valid)],
                                           GRAPH_LAUNCHES_EVAL)
        if not all(torch.equal(a, w) for a, w in zip(results["old"], results["new"])):
            raise AssertionError(f"A/B group_relabel {key}: old and new outputs differ")
        times = {"graph": [], "call": []}
        for version in ("old", "new", "new", "old"):
            times["graph"].append((version, round(_replay_ms(graphs[version],
                                                             GRAPH_LAUNCHES_EVAL), 5)))
            with _csrc_dir(build, dirs[version]):
                times["call"].append((version, round(_call_ms(
                    lambda: group.group_ranks(merge, valid), 50), 5)))
        chain, walk = _chain_depth(merge)
        out[key] = {"bound_ms": _relabel_bound_ms(merge, valid)[0], "chain_depth": chain,
                    "rows_plus_merges": walk, "merges": int(merge.sum()),
                    **{f"{k}_ms": [list(t) for t in ts] for k, ts in times.items()}}
        print(f"[{card}] A/B group_relabel {key} ({int(merge.sum())} merges): device ms "
              f"by graph replay {times['graph']}, wrapper loop {times['call']}; old and new "
              f"outputs bit-equal", flush=True)
    print(json.dumps({"ab_group_relabel": out}), flush=True)


def _kernel_times(recon, card, name, case, bound, n_sets, launches):
    """One kernel's row of measurements: cold and warm device ms, wrapper-loop
    ms, its plain version's ms, the bound and the fill of its outputs."""
    fn, plain = getattr(recon, name), getattr(recon, name + "_plain")
    sets = _input_sets(name, case, n_sets)
    cold = _capture(fn, sets, launches)
    cold_ms = _replay_ms(cold, launches)
    warm_ms = _replay_ms(_capture(fn, sets[:1], launches), launches)
    fill_ms = _replay_ms(_capture_fill(cold[1][1:]), launches)
    call_ms = _call_ms(lambda: fn(*sets[0]), 50)
    plain_ms = _call_ms(lambda: plain(*sets[0]), 10)
    bound_ms, bound_by = bound(case)
    print(f"[{card}] {name} N={case['c_m'].shape[1]}: device {cold_ms:.4f} ms at a cold "
          f"cache ({n_sets} input sets in turn, {launches} launches a graph), "
          f"{warm_ms:.4f} ms L2-warm; wrapper loop {call_ms:.4f} ms a call; plain "
          f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / cold_ms:.1%} of it reached; zero_() of the same outputs alone "
          f"{fill_ms:.4f} ms", flush=True)
    return dict(ms=cold_ms, kernel_ms=cold_ms, warm_ms=warm_ms, call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                output_fill_ms=fill_ms)


def _bound(read, write, ops):
    """(ms, "bytes" or "operations"): the larger of the bytes over the memory
    rate and the f32 operations over the f32 rate."""
    t_bytes = (read + write) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _recon_bytes_in(case):
    """Input bytes the trajectories need: the coefficients of the branch each
    ped uses, the bases of the branches in use, ori, rot, sca and mask."""
    n = case["c_m"].shape[1]
    moving = int(case["mask"].sum())
    return (K * S * 4 * n + 2 * T * K * 4 * (2 if 0 < moving < n else 1)
            + n * (8 + 16 + 4 + 1))


def _recon_metrics_bound_ms(case):
    """Least time for fused_recon_metrics on these inputs; each input byte
    read once (+ gt), each output byte written once. Per ped and sample: 2T*K
    FMAs, scale, rotate+translate (4 mul/add + 2 add per step), distance (5
    per step); TCC per ped ~ 8 per step."""
    n = case["c_m"].shape[1]
    read = _recon_bytes_in(case) + n * T * 2 * 4
    write = S * n * T * 2 * 4 + 3 * n * 4
    return _bound(read, write, n * S * T * (2 * 2 * K + 2 + 6 + 5) + n * T * 8)


def _reconstruct_bound_ms(case):
    """Least time for fused_reconstruct on these inputs: the recon bytes in,
    the (S, N, T, 2) trajectories out; per ped, sample and step 2*2*K FMAs,
    the scale and the rotate+translate."""
    n = case["c_m"].shape[1]
    return _bound(_recon_bytes_in(case), S * n * T * 2 * 4, n * S * T * (2 * 2 * K + 2 + 6))


def _col_bound_ms(valid, gather=None):
    """Least time for fused_col on this mask: the mask, each valid
    pedestrian's first 5 positions a sample (all its window needs) and its
    gather entry read once, COL written once; per (sample, valid pedestrian)
    the window's 4 x 2 differences and scalings and 13 x 2 sums, per
    (sample, valid pair) 14 distances of 7 operations (2 differences, 2
    products, a sum, a square root, a compare)."""
    counts = valid.sum(dim=1).long()
    nv, pairs = int(counts.sum()), int((counts * (counts - 1) // 2).sum())
    read = valid.numel() + nv * S * 5 * 2 * 4 + (nv * 8 if gather is not None else 0)
    return _bound(read, valid.numel() * 4, S * (nv * (4 * 2 * 2 + 13 * 2) + pairs * 14 * 7))


def _col_walkers(rows, slots, dense, seed, spread=3.0):
    """recon (S, rows*slots, T, 2) of walkers that start within `spread` of
    each other row by row (close pairs collide in some samples), and valid
    (rows, slots) with each row's first `dense` slots set, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    start = rng.random(size=(1, rows, slots, 1, 2)) * spread
    start += 10.0 * np.arange(rows)[None, :, None, None, None]
    vel = rng.normal(size=(1, rows, slots, 1, 2)) * 0.2
    noise = 0.05 * np.cumsum(rng.normal(size=(S, rows, slots, T, 2)), axis=3)
    recon = (start + vel * np.arange(T)[None, None, None, :, None] + noise).astype(np.float32)
    valid = np.zeros((rows, slots), bool)
    valid[:, :dense] = True
    return (torch.from_numpy(recon.reshape(S, rows * slots, T, 2)).cuda(),
            torch.from_numpy(valid).cuda())


def _col_main_inputs(tr):
    """fused_col's inputs on the main path: one test() of the block."""
    from eigentrajectory_tpu_torch.train import trainer as trainer_module

    seen, real = [], trainer_module.fused_col

    def noting(recon, valid, gather=None):
        seen.append((recon, valid))
        return real(recon, valid, gather)

    trainer_module.fused_col = noting
    try:
        tr.test(eval_batch=EVAL_BATCH)
    finally:
        trainer_module.fused_col = real
    if len(seen) != 1:
        raise AssertionError(f"test() of one block called fused_col {len(seen)} times")
    return seen[0]


def _check_col(col, card, main_args):
    """fused_col against its plain version on the card (COL counts samples:
    within 1e-5) on the main path's inputs, a block of dense scenes of 57
    walkers, the packed layout through a gather map, NaN futures, rows
    longer than a block's threads and past 48 KB of shared memory; returns
    the max abs error."""
    import numpy as np
    import torch
    from eigentrajectory_tpu_torch.data.batching import scene_gather

    recon_d, valid_d = _col_walkers(EVAL_BATCH, N_MAX, N_MAX, seed=21)
    long_r, long_v = _col_walkers(2, 500, 480, seed=22)
    nan_r = main_args[0].clone()
    nan_r[3, ::7, 2] = float("nan")
    sizes = np.random.default_rng(23).integers(1, 21, size=120)
    ids = np.random.default_rng(24).permutation(np.repeat(np.arange(len(sizes)), sizes))
    packed_r = _col_walkers(1, len(ids), len(ids), seed=25, spread=8.0)[0]
    packed = tuple(torch.from_numpy(x).cuda() for x in scene_gather(ids)[:2])
    cases = {f"main path {EVAL_BATCH}x{N_MAX}": main_args,
             f"dense {EVAL_BATCH}x{N_MAX}": (recon_d, valid_d), "long rows 2x500": (long_r, long_v),
             "NaN futures": (nan_r, main_args[1]),
             f"packed {len(ids)} walkers in {len(sizes)} scenes": (packed_r, packed[1], packed[0])}
    err = 0.0
    for label, args in cases.items():
        got, want = col.fused_col(*args), col.fused_col_plain(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"fused_col {label}: {m}")
        e = float((got - want).abs().max())
        err = max(err, e)
        print(f"fused_col check {label}: max_abs_err={e:.3e}, mean COL "
              f"{float(got[args[1]].mean()):.4f} over {int(args[1].sum())} walkers", flush=True)
    return err


def _col_times(col, card, main_args):
    """fused_col's row: cold and warm device ms by graph replay at the main
    path's inputs (each of COLD_SETS_EVAL sets a copy of the 35 MB
    trajectories), the wrapper loop's ms, the plain version's, and the
    bound; the same at the dense block of 57 walkers a row."""
    import torch

    out = {}
    for label, args in (("main", main_args),
                        ("dense", _col_walkers(EVAL_BATCH, N_MAX, N_MAX, seed=21))):
        sets = [args] + [tuple(x.clone() for x in args) for _ in range(COLD_SETS_EVAL - 1)]
        cold_ms = _replay_ms(_capture(col.fused_col, sets, GRAPH_LAUNCHES_EVAL),
                             GRAPH_LAUNCHES_EVAL)
        warm_ms = _replay_ms(_capture(col.fused_col, sets[:1], GRAPH_LAUNCHES_EVAL),
                             GRAPH_LAUNCHES_EVAL)
        call_ms = _call_ms(lambda: col.fused_col(*args), 50)
        plain_ms = _call_ms(lambda: col.fused_col_plain(*args), 10)
        bound_ms, bound_by = _col_bound_ms(args[1])
        print(f"[{card}] fused_col {label} {EVAL_BATCH}x{N_MAX} ({int(args[1].sum())} walkers): "
              f"device {cold_ms:.4f} ms at a cold cache, {warm_ms:.4f} ms L2-warm; wrapper loop "
              f"{call_ms:.4f} ms a call; plain {plain_ms:.4f} ms; bound {bound_ms:.6f} ms "
              f"({bound_by}), {bound_ms / cold_ms:.1%} of it reached", flush=True)
        row = dict(ms=cold_ms, kernel_ms=cold_ms, warm_ms=warm_ms, call_ms=call_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        if label == "main":
            out.update(row)
        else:
            out["dense_57"] = row
    return out


def _attention_inputs(kind, b, p, seed, scenes=None, cut=False):
    """`agent_attention`'s arguments on the card for `b` rows of `p` slots:
    q, k, v and q_self, k_self as the projections leave them (views of
    (B, L, 3E) and (B, L, 2E) tensors; cross-attention's k, v of a
    (B, S, 2E) one), q and q_self scaled by 1/sqrt(32); the agent mask with
    -1e9 across `scenes` (-1: padding) or -inf between slots farther than
    0.8 apart under `cut`; the key bias -1e9 on each row's padded slots
    (2-20 valid of each row, or the ids' -1)."""
    import torch

    tq, tk, causal = ATTN_KINDS[kind]
    e = ATTN_WIDTH
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, generator=g).cuda()
    if kind == "cross":
        q, q_self = rand(b, tq * p, e), rand(b, tq * p, e)
        k, v = rand(b, tk * p, 2 * e).chunk(2, dim=-1)
        k_self = rand(b, tk * p, e)
    else:
        q, k, v = rand(b, tq * p, 3 * e).chunk(3, dim=-1)
        q_self, k_self = rand(b, tq * p, 2 * e).chunk(2, dim=-1)
    scaling = (e // ATTN_HEADS) ** -0.5
    if scenes is None:
        valid = torch.arange(p)[None, :] < torch.randint(2, min(p, 20) + 1, (b, 1), generator=g)
    else:
        ids = torch.as_tensor(scenes)[None].expand(b, p)
        valid = ids >= 0
    zero = torch.zeros(())
    key_bias = torch.where(valid, zero, torch.full_like(zero, -1e9))
    agent_mask = torch.zeros(b, p, p)
    if cut:
        cur = torch.rand(b, p, 2, generator=g) * 2
        dist = torch.linalg.vector_norm(cur[:, :, None] - cur[:, None], dim=-1)
        agent_mask = torch.where(dist > 0.8, torch.full_like(zero, -math.inf), zero)
    if scenes is not None:
        agent_mask = agent_mask + torch.where(ids[:, :, None] != ids[:, None, :],
                                              torch.full_like(zero, -1e9), zero)
    return (q * scaling, k, v, q_self * scaling, k_self, agent_mask.cuda(), key_bias.cuda(),
            ATTN_HEADS, causal)


def _packed_ids(p, seed, pad=4):
    """Scene ids of a packed row of p slots: scenes of 2-20 interleaved,
    the last `pad` slots padding (-1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < p - pad:
        sizes.append(int(rng.integers(2, COLLATED_MAX_PEDS + 1)))
    ids = np.repeat(np.arange(len(sizes)), sizes)[:p - pad]
    return rng.permutation(ids).tolist() + [-1] * pad


def _attention_bound_ms(kind, b, p):
    """Least time for one attention of `kind` over b rows of p slots: q,
    q_self, k, v, k_self, the masks read once and the output written once;
    the operations the inputs need: per (query, key) pair a query reaches (a
    causal query the keys of its step and earlier) and per width 2 FMAs
    (q . k and the weight times v), per query and key step one same-agent
    product of the width, 2 operations an FMA (exp and the softmax's
    bookkeeping not counted)."""
    tq, tk, causal = ATTN_KINDS[kind]
    e = ATTN_WIDTH
    pairs = p * p * (tq * (tq + 1) // 2 if causal else tq * tk)
    ops = b * (2 * 2 * e * pairs + 2 * e * tq * p * tk)
    read = b * 4 * (2 * tq * p * e + 3 * tk * p * e + p * p + p)
    return _bound(read, b * 4 * tq * p * e, ops)


def _check_attention(attention, card):
    """The kernel against its plain version: the three kinds at the serve
    cell's mean request (ATTN_SERVE_ROWS rows of 32 slots) and at the
    packed test() row (P = ATTN_PACKED_SLOTS, scene ids), and with an -inf
    agent mask; returns the largest |kernel - plain|."""
    import numpy as np
    import torch

    cases = [(kind, ATTN_SERVE_ROWS, AF_BUCKET, {}) for kind in ATTN_KINDS]
    cases += [(kind, 1, ATTN_PACKED_SLOTS, {"scenes": _packed_ids(ATTN_PACKED_SLOTS, 5)})
              for kind in ATTN_KINDS]
    cases += [(kind, 7, 23, {"cut": True}) for kind in ATTN_KINDS]
    worst = 0.0
    for i, (kind, b, p, kw) in enumerate(cases):
        args = _attention_inputs(kind, b, p, seed=40 + i, **kw)
        with torch.no_grad():
            got, want = attention.agent_attention(*args), attention.agent_attention_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(want).all():
            raise AssertionError(f"agent_attention {kind} {b}x{p}: the plain version is not finite")
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=f"agent_attention {kind} {b}x{p} {kw and 'masked'}")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        print(f"agent_attention check {kind} {b}x{p}{' ' + next(iter(kw)) if kw else ''}: "
              f"max_abs_err={err:.3e}", flush=True)
    return worst


def _attention_times(attention, card):
    """agent_attention's row: for each kind at the serve cell's mean request
    and at the packed row, cold and warm device ms by graph replay (two
    input sets in turn: one encoder set at the request is ~200 MB), the
    wrapper loop's ms, the plain version's and the bound; and the sums over
    a forward's six attentions (two of each kind)."""
    import torch

    out = {}
    for shape, (b, p, kw) in (("request", (ATTN_SERVE_ROWS, AF_BUCKET, {})),
                              ("packed", (1, ATTN_PACKED_SLOTS,
                                          {"scenes": _packed_ids(ATTN_PACKED_SLOTS, 5)}))):
        rows = {}
        for kind in ATTN_KINDS:
            sets = [_attention_inputs(kind, b, p, seed=60 + i, **kw) for i in range(2)]
            fn = lambda *args: attention.agent_attention(*args)
            with torch.no_grad():
                cold_ms = _replay_ms(_capture(fn, sets, ATTN_LAUNCHES), ATTN_LAUNCHES)
                warm_ms = _replay_ms(_capture(fn, sets[:1], ATTN_LAUNCHES), ATTN_LAUNCHES)
                call_ms = _call_ms(lambda: fn(*sets[0]), 20)
                plain_ms = _call_ms(lambda: attention.agent_attention_plain(*sets[0]), 5)
            bound_ms, bound_by = _attention_bound_ms(kind, b, p)
            rows[kind] = dict(ms=cold_ms, warm_ms=warm_ms, call_ms=call_ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
            print(f"[{card}] agent_attention {kind} {b}x{p} slots: device {cold_ms:.4f} ms at a "
                  f"cold cache, {warm_ms:.4f} ms L2-warm; wrapper loop {call_ms:.4f} ms a call; "
                  f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{bound_ms / cold_ms:.1%} of it reached", flush=True)
            del sets
            torch.cuda.empty_cache()
        total = {key: 2 * sum(r[key] for r in rows.values())
                 for key in ("ms", "warm_ms", "call_ms", "plain_ms", "bound_ms")}
        print(f"[{card}] agent_attention, a forward's six attentions at {b}x{p} slots: device "
              f"{total['ms']:.4f} ms cold, {total['warm_ms']:.4f} ms warm; plain "
              f"{total['plain_ms']:.4f} ms; bound {total['bound_ms']:.4f} ms, "
              f"{total['bound_ms'] / total['ms']:.1%} of it reached", flush=True)
        row = dict(total, kernel_ms=total["ms"], bound_by="operations", kinds=rows)
        if shape == "request":
            out.update(row)
        else:
            out["packed_147"] = row
    return out


def _agentformer_peak(card, tr, whole, bucket, baseline=None):
    """Peak device memory of one whole-split ET-AgentFormer request at
    `bucket` slots a scene (max_memory_allocated over the second call);
    the futures within 1e-5 of `baseline` (the same request at another
    bucket), where given. Returns (peak bytes, futures)."""
    import numpy as np
    import torch
    from eigentrajectory_tpu_torch.inference import ETPredictor

    predictor = ETPredictor(tr, bucket=bucket)
    predictor.predict(*whole)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    futures = predictor.predict(*whole)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[{card}] agentformer predict() of the whole split ({len(whole[0])} peds, "
          f"{len(np.unique(whole[1]))} scenes) at bucket={bucket}: peak device memory "
          f"{peak} B = {peak / 2**30:.3f} GiB (max_memory_allocated; {before} B held before "
          f"the call)", flush=True)
    if baseline is not None:
        np.testing.assert_allclose(futures, baseline, atol=1e-5, rtol=1e-5,
                                   err_msg=f"agentformer predict() at bucket={bucket}")
    return peak, futures


def _attention_phase(card, attention, tr, whole):
    """Step 9b: the agent-aware attention kernel against its plain version
    and its times; the peak memory of the whole-split request at AF_BUCKET
    and at BUCKET slots (`tr`: the zara2 trainer, `whole`: the request).
    Returns (row measurements, max abs error)."""
    err = _check_attention(attention, card)
    times = _attention_times(attention, card)
    peak_small, futures = _agentformer_peak(card, tr, whole, AF_BUCKET)
    peak_large, _ = _agentformer_peak(card, tr, whole, BUCKET, baseline=futures)
    times.update(peak_bytes_at_bucket_32=peak_small, peak_bytes_at_bucket_128=peak_large)
    return times, err


def _fused_attention(label, attention, fn):
    """Run fn() with the attention kernel's launch count reset just before
    it, counting ET-AgentFormer's forwards on the card; each must launch the
    kernel once for each of its attentions. Returns (fn's result, launches)."""
    import torch
    from eigentrajectory_tpu_torch.models import agentformer

    forwards = []

    def note(module, inputs, output):
        if isinstance(module, agentformer.AgentFormerLight) and \
                next(module.parameters()).device.type == "cuda":
            forwards.append(module)

    hook = torch.nn.modules.module.register_module_forward_hook(note)
    try:
        attention.LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        launches = attention.LAUNCHES
    finally:
        hook.remove()
    per_forward = agentformer.NLAYER_ENC + 2 * agentformer.NLAYER_DEC
    if not forwards or launches != per_forward * len(forwards):
        raise AssertionError(f"agentformer {label}: the attention kernel launched {launches} "
                             f"times in {len(forwards)} forwards on the card, expected "
                             f"{per_forward} a forward")
    print(f"agentformer {label}: agent_attention launches={launches} in {len(forwards)} "
          f"forwards on the card ({per_forward} a forward)", flush=True)
    return out, launches


def _walkers(n, seed):
    """One scene of n pedestrians drawn as make_synthetic_data draws them:
    (n, obs_len, 2) float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(20)[None, :, None]
    traj = (rng.normal(size=(n, 1, 2)) * 5 + rng.normal(size=(n, 1, 2)) * t * 0.4
            + 0.05 * np.cumsum(rng.normal(size=(n, 20, 2)), axis=1))
    return traj[:, :8].astype(np.float32)


def _host_times(fn, card, label, n_traj, runs=50):
    """Median and p80 of `runs` host-clock runs of fn (ending in a
    synchronize) after 5 warm-up runs; printed with the card; returns the
    median in s."""
    import torch

    for _ in range(5):
        fn()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    walls.sort()
    median, p80 = walls[len(walls) // 2], walls[runs * 4 // 5 - 1]   # a fifth above p80
    print(f"[{card}] {label} wall over {len(walls)} runs: median {median * 1e3:.3f} ms, "
          f"p80 {p80 * 1e3:.3f} ms, min {walls[0] * 1e3:.3f} ms; "
          f"{n_traj / median:.1f} trajectories/s at the median, {n_traj / p80:.1f} at p80",
          flush=True)
    return median


def _profile(label, fn, card, wall_s, out_dir):
    """One run of fn under torch.profiler: the table goes to
    out_dir/profile_<label>.txt; the device's busy share of the unprofiled
    median wall time and the kernel time of each span go to stdout.

    The profiler links a kernel to a range only through the PyTorch operator
    that launched it. A kernel launched through ctypes is in the trace, by
    name and with its device time, but linked to no operator, so no range
    counts it (with nvcc's static cudart and with the shared one alike).
    Each hand-written kernel's span therefore reads its kernel's device time
    by name from the trace, and the run fails if the trace does not hold it.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = {e.key: e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    busy_us = sum(kernels.values())
    # Kernel time launched inside each span (the CPU-side range; its GPU-side
    # twin measures the range's extent on the device timeline).
    spans = {}
    for e in prof.events():
        if e.name.startswith(("eval.", "serve.", "gpgraph.")) and e.device_type == DeviceType.CPU:
            spans[e.name] = spans.get(e.name, 0.0) + e.device_time_total
    attributed = {}
    for span, kernel in KERNEL_SPANS.items():
        if span in spans:
            attributed[span] = spans[span]
            spans[span] = sum(us for name, us in kernels.items() if kernel in name)
            if spans[span] <= 0:
                raise AssertionError(f"profile {label}: no device time for {kernel} in the trace")
    os.makedirs(out_dir, exist_ok=True)
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(f"{card}\n{table}\n")
    ms = lambda d: json.dumps({k: round(v / 1e3, 4) for k, v in sorted(d.items())})
    print(f"[{card}] profiled {label}: device busy {busy_us / 1e3:.3f} ms = "
          f"{busy_us / 1e3 / (wall_s * 1e3):.1%} of the median wall; kernel ms by span "
          f"{ms(spans)}; the profiler's own attribution of the kernel spans {ms(attributed)}",
          flush=True)


def _check_test(name, tr, tr_cpu, recon):
    """test() on the card with the launch count reset just before it, and the
    same run on the CPU; returns (means, launches)."""
    import torch

    recon.LAUNCHES = recon.RECONSTRUCT_LAUNCHES = 0
    res = tr.test(eval_batch=EVAL_BATCH)
    torch.cuda.synchronize()
    launches = recon.LAUNCHES
    print(f"{name} test() on the card: {res}, fused_recon_metrics launches={launches}",
          flush=True)
    if launches < 1:
        raise AssertionError(f"{name} test() did not launch fused_recon_metrics")
    if not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"{name}: non-finite metrics {res}")
    res_cpu = tr_cpu.test(eval_batch=EVAL_BATCH)
    print(f"{name} test() on the CPU:  {res_cpu}", flush=True)
    for key, want in res_cpu.items():
        if not abs(res[key] - want) <= ATOL + RTOL * abs(want):
            raise AssertionError(f"{name} {key}: card {res[key]} vs CPU {want}")
    return res, launches


def _check_request(name, label, card_p, cpu_p, ref_p, obs, ids, strict):
    """One request on the card, with the launch count reset just before it,
    against the CPU's float32 and float64 runs of the same code; returns the
    card's futures and its fused_reconstruct launches."""
    import numpy as np
    import torch
    from eigentrajectory_tpu_torch import inference
    from eigentrajectory_tpu_torch.ops import recon

    # Note the shape predict() hands to fused_reconstruct on its way through.
    shapes, wrapper = [], inference.fused_reconstruct

    def noting(c_m, *rest):
        shapes.append(tuple(c_m.shape))
        return wrapper(c_m, *rest)

    inference.fused_reconstruct = noting
    try:
        recon.LAUNCHES = recon.RECONSTRUCT_LAUNCHES = 0
        got = card_p.predict(obs, ids)
        torch.cuda.synchronize()
        launches = recon.RECONSTRUCT_LAUNCHES
    finally:
        inference.fused_reconstruct = wrapper
    if launches < 1:
        raise AssertionError(f"{name} {label}: predict() did not launch fused_reconstruct")
    if shapes != [(K, len(obs), S)]:
        raise AssertionError(f"{name} {label}: fused_reconstruct was given c_m of {shapes}, "
                             f"expected the request's pedestrians, {(K, len(obs), S)}")
    if got.shape != (S, len(obs), T, 2) or got.dtype != np.float32:
        raise AssertionError(f"{name} {label}: futures {got.shape} {got.dtype}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{name} {label}: non-finite futures")
    cpu, ref = cpu_p.predict(obs, ids), ref_p.predict(obs, ids)
    gap = float(np.abs(got - cpu).max())
    e_cpu, e_card = float(np.abs(cpu - ref).max()), float(np.abs(got - ref).max())
    print(f"{name} predict {label}: {len(obs)} peds in {len(np.unique(ids))} scenes, "
          f"fused_reconstruct launches={launches} at c_m {shapes[0]}; "
          f"max |card - CPU f32| {gap:.3e}, "
          f"|CPU f32 - f64| {e_cpu:.3e}, |card - f64| {e_card:.3e}", flush=True)
    # The card must be as close to the exact answer as the CPU's own f32 run.
    np.testing.assert_allclose(got, ref, atol=ATOL + 2 * e_cpu, rtol=RTOL,
                               err_msg=f"{name} {label}: card vs float64")
    if strict:
        np.testing.assert_allclose(got, cpu, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} {label}: card vs CPU f32")
    return got, launches


def _serve(name, cfg, splits, requests, loose=(("stgcnn", "(c)"),), bucket=BUCKET,
           tag="parity"):
    """The serving checks of one model at `bucket` slots a scene, from the
    checkpoint of `tag`; returns (card predictor, launches). The requests
    (name, label) in `loose` are held to the float64 run alone."""
    import numpy as np
    import torch
    from eigentrajectory_tpu_torch.inference import ETPredictor
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    card_p = ETPredictor.from_checkpoint(cfg, tag, bucket=bucket, datasets=splits)
    cpu_p = ETPredictor.from_checkpoint(cfg, tag, bucket=bucket, datasets=splits,
                                        device="cpu")
    ref_tr = ETTorchTrainer(cfg, tag=tag, datasets=splits, device="cpu",
                            dtype=torch.float64)
    ref_tr.load_model()
    ref_p = ETPredictor(ref_tr, bucket=bucket)
    launches = 0
    for label, (obs, ids) in requests.items():
        # ET-STGCNN's inverse-distance adjacency is ill-conditioned on the
        # dense 150-ped scene: two correct f32 runs differ there by ~1e-3, so
        # that request is held to the float64 run alone.
        got, n = _check_request(name, label, card_p, cpu_p, ref_p, obs, ids,
                                strict=(name, label) not in loose)
        launches += n
        if label == "(a)":
            other = _walkers(3, seed=12)
            both = card_p.predict(np.concatenate([obs, other]), np.repeat([0, 1], [5, 3]))
            np.testing.assert_allclose(both[:, :5], got, atol=ATOL,
                                       err_msg=f"{name}: scene alone vs in a two-scene request")
    return card_p, launches


def _sync_ms(fn):
    """(result, host ms, device ms) of fn: the host clock with a synchronize
    at each end, and two CUDA events around the same work (the stretch of the
    device's timeline the work takes, its idle gaps included)."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(stop)


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _timed_fit_parts(facade, sync):
    """Wrap the facade's `fit_basis` and `generate_anchors` so that a call of
    calculate_parameters notes the seconds of each (after `sync()`) and, for
    the anchors, the inertia of the fitted centres on their coefficients.
    Returns (notes, undo)."""
    from eigentrajectory_tpu_torch.etspace import anchor

    notes = {"basis_s": 0.0, "kmeans_s": 0.0, "inertia": []}
    fit_basis, generate_anchors = facade.fit_basis, facade.generate_anchors

    def timed_basis(*args, **kw):
        sync()
        t0 = time.perf_counter()
        out = fit_basis(*args, **kw)
        sync()
        notes["basis_s"] += time.perf_counter() - t0
        return out

    def timed_anchors(generator, pred_norm, u_pred, num_samples):
        sync()
        t0 = time.perf_counter()
        out = generate_anchors(generator, pred_norm, u_pred, num_samples)
        sync()
        notes["kmeans_s"] += time.perf_counter() - t0
        coef = (pred_norm.flatten(1) @ u_pred).float()
        notes["inertia"].append(float(anchor._assign_update(coef, out.T.contiguous())[1]))
        return out

    facade.fit_basis, facade.generate_anchors = timed_basis, timed_anchors

    def undo():
        facade.fit_basis, facade.generate_anchors = fit_basis, generate_anchors

    return notes, undo


def _check_descriptor(name, card, tr, tr_cpu):
    """init_descriptor() on the card and on the CPU from the same seed."""
    import torch
    from eigentrajectory_tpu_torch.etspace import facade

    fits = {}
    for label, trainer, sync in (("card", tr, torch.cuda.synchronize), ("cpu", tr_cpu, lambda: None)):
        notes, undo = _timed_fit_parts(facade, sync)
        try:
            t0 = time.perf_counter()
            trainer.init_descriptor()
            sync()
            notes["total_s"] = time.perf_counter() - t0
        finally:
            undo()
        fits[label] = notes
    et, et_cpu = tr.et, tr_cpu.et
    k = tr.cfg.k
    eye = torch.eye(k, device="cuda")
    basis_gap = ortho = 0.0
    for basis, basis_cpu in ((et.basis_m, et_cpu.basis_m), (et.basis_s, et_cpu.basis_s)):
        for u, u_cpu in zip(basis, basis_cpu):
            if not torch.isfinite(u).all():
                raise AssertionError(f"{name}: non-finite basis")
            ortho = max(ortho, float((u.T @ u - eye).abs().max()))
            basis_gap = max(basis_gap, float((u.cpu() - u_cpu).abs().max()))
    if ortho > 1e-5 or basis_gap > 1e-5:
        raise AssertionError(f"{name}: bases off orthonormal by {ortho:.2e}, card vs CPU fit "
                             f"{basis_gap:.2e} (both must be <= 1e-5)")
    anchor_gap = 0.0
    for a, a_cpu in ((et.anchor_m, et_cpu.anchor_m), (et.anchor_s, et_cpu.anchor_s)):
        if tuple(a.shape) != (k, tr.cfg.num_samples) or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: anchors {tuple(a.shape)} or non-finite")
        anchor_gap = max(anchor_gap, float((a.cpu() - a_cpu).abs().max()))
    for got, want in zip(fits["card"]["inertia"], fits["cpu"]["inertia"]):
        if abs(got - want) > 0.01 * want:
            raise AssertionError(f"{name}: k-means inertia on the card {got} vs CPU fit {want}")
    c = fits["card"]
    print(f"[{card}] {name} init_descriptor() on the card {c['total_s']:.3f} s: basis fit "
          f"(normalization + host float64 SVD) {c['basis_s']:.3f} s, k-means "
          f"{c['kmeans_s']:.3f} s; on the CPU {fits['cpu']['total_s']:.3f} s "
          f"(k-means {fits['cpu']['kmeans_s']:.3f} s). Bases orthonormal within {ortho:.2e}, "
          f"card vs CPU fit {basis_gap:.2e}; anchors' inertia (moving, static) card "
          f"{c['inertia']} vs CPU {fits['cpu']['inertia']}, max |anchor difference| "
          f"{anchor_gap:.2e}", flush=True)
    return c


def _copy_trainer(tr, device, dtype):
    """A trainer of tr's configuration and splits on `device` with tr's
    weights, BN statistics and ET parameters."""
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    other = ETTorchTrainer(tr.cfg, tag=tr.tag, device=device, dtype=dtype,
                           datasets=(tr.data_train, tr.data_val, tr.data_test))
    other.model.load_state_dict(tr.model.state_dict())
    other._set_et(tr.et)
    return other


@contextmanager
def _predictor_inputs(tr, feed=None):
    """Within the block, record for each call of tr's predictor the (c_obs,
    obs_ori) that its projection hands it, in float64 on the CPU; with `feed`
    (such a record), hand the predictor those in their place."""
    seen = []
    own = tr._predictor_fn

    def fn(c_obs, obs_ori, aux):
        seen.append((c_obs.detach().double().cpu(), obs_ori.detach().double().cpu()))
        if feed is not None:
            c_obs, obs_ori = (x.to(c_obs.device, c_obs.dtype) for x in feed[len(seen) - 1])
        return own(c_obs, obs_ori, aux)

    tr._predictor_fn = fn
    try:
        yield seen
    finally:
        del tr._predictor_fn


def _check_one_step(name, tr, batch, label, train_mode=True, edge_keeps=None):
    """One step's loss, gradients and BN statistics from the same weights on
    the card and on the CPU in float32 and float64, in two parts. The weights
    do not move (no optimizer update) and the card's BN statistics are put
    back. `train_mode=False` takes the step in eval mode: dropout off, for a
    model without BN (the runs draw from their own generators).
    `edge_keeps`, DropEdge's masks for the block, drawn once on the CPU,
    gives the runs the same draws (none of them reads its own generator).
    Returns the card's gradients by parameter name (float64, on the CPU).

    1. The predictor's inputs, the ET coefficients and origins that each
       device's projection gives: the card's within the CPU f32's distance
       from the CPU f64's + 1e-6 of their scale.
    2. The step from the card's inputs: the CPU runs take them in place of
       their own, so that all three compute one function of the same
       numbers. The card's loss within 1e-5 relative of both CPU runs, each
       of its gradient tensors within the CPU f32's distance from the f64
       run + 1e-4 of the tensor's scale, BN statistics within 1e-5.

    Reported beside them: a float64 step on the CPU's own float64 inputs,
    against the one on the card's: what rounding the inputs to float32
    moves in exact arithmetic (ET-Graph-TERN's 1/d relations turn an ulp of
    a close pair's coefficients into ~1e-3 of its 1/d entry)."""
    import torch

    runs = {}
    stats_before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    devices = [("card", tr), ("cpu32", _copy_trainer(tr, "cpu", torch.float32)),
               ("cpu64", _copy_trainer(tr, "cpu", torch.float64)),
               ("cpu64 own inputs", _copy_trainer(tr, "cpu", torch.float64))]
    for key, trainer in devices:
        feed = None if key in ("card", "cpu64 own inputs") else runs["card"][3]
        trainer.model.train(train_mode)
        with _predictor_inputs(trainer, feed) as seen:
            loss = trainer.loss_and_grads(*trainer._to_device(batch), edge_keeps=edge_keeps)
        trainer.model.eval()
        runs[key] = (float(loss),
                     {n: p.grad.detach().double().cpu()
                      for n, p in trainer.model.named_parameters() if p.grad is not None},
                     {n: b.detach().double().cpu() for n, b in trainer.model.named_buffers()},
                     seen)
    tr.model.load_state_dict(stats_before)
    (l_card, g_card, s_card, x_card), (l_32, g_32, s_32, x_32), (l_64, g_64, s_64, x_64), \
        (l_own, g_own, _, _) = (runs[k] for k, _ in devices)

    # --- 1. the predictor's inputs ---
    in_card = in_32 = 0.0
    for call_card, call_32, call_64 in zip(x_card, x_32, x_64):
        for what, card, f32, f64 in zip(("c_obs", "obs_ori"), call_card, call_32, call_64):
            scale = float(f64.abs().max())
            e_card, e_32 = float((card - f64).abs().max()), float((f32 - f64).abs().max())
            if not e_card <= e_32 + 1e-6 * scale:
                raise AssertionError(f"{name} {label}: predictor input {what}: |card - CPU f64| "
                                     f"{e_card:.3e}, |CPU f32 - f64| {e_32:.3e}, scale {scale:.3e}")
            in_card, in_32 = max(in_card, e_card / scale), max(in_32, e_32 / scale)

    # --- 2. the step from the card's inputs ---
    for other, what in ((l_32, "CPU f32"), (l_64, "CPU f64")):
        if not abs(l_card - other) <= 1e-5 * abs(other):
            raise AssertionError(f"{name} {label}: step loss card {l_card} vs {what} {other}")
    if set(g_card) != set(g_64) or not g_card:
        raise AssertionError(f"{name} {label}: gradients of other parameters on the card")
    # A gradient that is NaN in the exact run (GP-Graph's group_cnn: the
    # norm's gradient at a zero difference, which the optimizer zeroes) must
    # be NaN at the same entries in every run.
    nan = {n for n, ref in g_64.items() if torch.isnan(ref).any()}
    for n in nan:
        where = torch.isnan(g_64[n])
        if not all(torch.equal(torch.isnan(g[n]), where) for g in (g_card, g_32, g_own)):
            raise AssertionError(f"{name} {label}: gradient of {n} NaN at other entries")
    # A tensor whose true gradient is 0 (a conv bias in front of a BatchNorm)
    # holds rounding noise of the size of the gradients around it: its scale
    # is at least a thousandth of the largest entry of any gradient tensor.
    floor = 1e-3 * max(float(ref.abs().max()) for n, ref in g_64.items() if n not in nan)
    worst, worst_own, spread, past = (0.0, 0.0, ""), (0.0, 0.0, 0.0, ""), (0.0, ""), 0
    for n, ref in g_64.items():
        if n in nan:
            continue
        top = max(float(ref.abs().max()), floor)
        e_card = float((g_card[n] - ref).abs().max())
        e_cpu = float((g_32[n] - ref).abs().max())
        if not e_card <= e_cpu + 1e-4 * top:
            raise AssertionError(f"{name} {label}: gradient of {n}: |card - f64| {e_card:.3e}, "
                                 f"|CPU f32 - f64| {e_cpu:.3e}, scale {top:.3e}")
        worst = max(worst, (e_card / top, e_cpu / top, n))
        # the card's distance from the float64 step on the CPU's own inputs,
        # and the part of it that rounding the inputs alone makes
        e_own = float((g_own[n] - ref).abs().max()) / top
        worst_own = max(worst_own, (float((g_card[n] - g_own[n]).abs().max()) / top, e_own,
                                    e_card / top, n))
        spread = max(spread, (e_own, n))
        past += e_own > 1e-4
    stat_gap = 0.0
    for n, ref in s_64.items():
        gap = float((s_card[n] - ref).abs().max())
        if not torch.allclose(s_card[n], ref, atol=1e-5, rtol=1e-5) or \
                not torch.allclose(s_card[n], s_32[n], atol=1e-5, rtol=1e-5):
            raise AssertionError(f"{name} {label}: BN statistic {n} card vs CPU: {gap:.3e}")
        stat_gap = max(stat_gap, gap)
    if hasattr(batch, "scene_ids"):
        what = (f"{int(batch.scene_ids.max()) + 1} scenes, {int(batch.ped_valid.sum())} "
                f"pedestrians in {len(batch.ped_valid)} slots")
    else:
        what = f"{int(batch.scene_valid.sum())} real scenes of {len(batch.scene_valid)}"
    print(f"{name} one step, {label} ({what}): predictor inputs |card - CPU f64| {in_card:.2e} "
          f"of scale (CPU f32: {in_32:.2e}); from the card's inputs: loss card {l_card:.8f}, "
          f"CPU f32 {l_32:.8f}, CPU f64 {l_64:.8f}; {len(g_64)} gradient tensors ({len(nan)} NaN on all "
          f"runs), worst "
          f"|card - f64| / the tensor's scale {worst[0]:.2e} (CPU f32: {worst[1]:.2e}) at "
          f"{worst[2]}; {len(s_64)} BN statistics, max |card - f64| {stat_gap:.2e}. "
          f"Rounding the inputs: f64 on the CPU's own f64 inputs, loss {l_own:.8f}, gradients "
          f"up to {spread[0]:.2e} of scale from f64 on the card's (at {spread[1]}; {past} "
          f"tensors past 1e-4); the card's worst distance from it {worst_own[0]:.2e} at "
          f"{worst_own[3]}, of which the inputs' rounding {worst_own[1]:.2e} and the card's "
          f"arithmetic {worst_own[2]:.2e}", flush=True)
    return g_card


def _loss_recon_ms(tr, batch, iters=20):
    """The reconstruction inside the training loss, alone, at the step's
    shape: einsum with the basis, denormalize and select, for both branches,
    forward and forward + backward, by CUDA events (mean of `iters`)."""
    import torch
    from eigentrajectory_tpu_torch.etspace.descriptor import reconstruct
    from eigentrajectory_tpu_torch.etspace.facade import moving_mask
    from eigentrajectory_tpu_torch.etspace.normalizer import compute_norm_params

    obs = tr._to_device(batch)[0]
    p = compute_norm_params(obs, eps=1e-8)
    p_s = type(p)(*(x[:, None] for x in p))
    mask = moving_mask(obs, tr.cfg.static_dist)[:, None, :, None, None]
    b, n = obs.shape[:2]
    coef = torch.randn(b, tr.cfg.k, n, tr.cfg.num_samples, device="cuda", requires_grad=True)

    def forward():
        return torch.where(mask, reconstruct(coef, tr.et.basis_m.U_pred, p_s, True),
                           reconstruct(coef, tr.et.basis_s.U_pred, p_s, False))

    def both():
        coef.grad = None
        forward().sum().backward()

    return _call_ms(forward, iters), _call_ms(both, iters)


def _step_parts(card, name, tr, epoch):
    """Where a train step's time goes: the four parts of each step of one
    epoch, each between two CUDA events and on the host clock with a
    synchronize at each end; medians over the epoch's steps."""
    from eigentrajectory_tpu_torch.data.batching import SceneBatcher
    from eigentrajectory_tpu_torch.models.common import draw_edge_keeps, set_edge_keeps

    parts = {k: ([], []) for k in ("to_device", "forward", "backward", "optimizer")}

    def timed(part, fn):
        out, host_ms, device_ms = _sync_ms(fn)
        parts[part][0].append(host_ms)
        parts[part][1].append(device_ms)
        return out

    tr.model.train()
    batches = list(SceneBatcher(tr.data_train, tr.cfg.batch_size, True, tr.n_max,
                                seed=tr.cfg.seed + epoch))
    for batch in batches:
        tr.optimizer.zero_grad(set_to_none=True)
        args = timed("to_device", lambda: tr._to_device(batch))
        set_edge_keeps(tr.model, draw_edge_keeps(tr.model, tr.dropout_generator,
                                                 *args[0].shape[:2]))    # DropEdge, if any
        loss = timed("forward", lambda: tr._chunk_loss(*args))
        timed("backward", loss.backward)
        timed("optimizer", tr.apply_gradients)
    set_edge_keeps(tr.model, None)
    tr.model.eval()
    recon_fwd, recon_both = _loss_recon_ms(tr, batches[0])
    summary = {k: (round(_median(host), 4), round(_median(dev), 4))
               for k, (host, dev) in parts.items()}
    print(f"[{card}] {name} train step by parts, median of {len(batches)} steps, "
          f"(host ms with a synchronize at each end, ms between two CUDA events): "
          f"{json.dumps(summary)}; the loss's reconstruction alone (einsum + denormalize + "
          f"select, both branches, {tr.cfg.batch_size}x{tr.n_max} slots): forward "
          f"{recon_fwd:.4f} ms, forward + backward {recon_both:.4f} ms", flush=True)


def _profile_train(card, name, tr, epoch, out_dir):
    """One training epoch under torch.profiler: device busy share of the
    epoch's train() wall, and the kernel time launched under each train.*
    span. A kernel counts for the span in whose host-side time window the
    operator that launched it began: the backward's operators run on the
    autograd thread, outside the main thread's range, so nesting alone would
    miss them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(epoch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    if busy_us <= 0:
        raise AssertionError("profile train: the trace holds no device time")
    windows = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
               if e.name.startswith("train.") and e.device_type == DeviceType.CPU]
    spans = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels or e.name.startswith("train"):
            continue
        us = sum(k.duration for k in e.kernels)
        for span, start, end in windows:
            if start <= e.time_range.start <= end:
                spans[span] = spans.get(span, 0.0) + us
                break
        else:
            spans["outside the spans"] = spans.get("outside the spans", 0.0) + us
    steps = sum(1 for w in windows if w[0] == "train.optimizer")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_train_{name}.txt"), "w") as f:
        f.write(f"{card}\n{events.table(sort_by='cuda_time_total', row_limit=60)}\n")
    per_step = {k: round(v / 1e3 / max(steps, 1), 4) for k, v in sorted(spans.items())}
    print(f"[{card}] profiled {name} train() epoch of {steps} steps: wall {wall_ms:.3f} ms "
          f"under the profiler, device busy {busy_us / 1e3:.3f} ms = "
          f"{busy_us / 1e3 / wall_ms:.1%} of it; kernel ms a step by span "
          f"{json.dumps(per_step)}", flush=True)


@contextmanager
def _synced_steps():
    """Have the trainers that fit() makes in this block time each step with a
    synchronize at each end."""
    import torch
    from eigentrajectory_tpu_torch.train import trainer as trainer_module
    from eigentrajectory_tpu_torch.utils.profiling import StepTimer

    class SyncStepTimer(StepTimer):
        def start(self):
            torch.cuda.synchronize()
            super().start()

        def stop(self):
            torch.cuda.synchronize()
            super().stop()

    trainer_module.StepTimer = SyncStepTimer
    try:
        yield
    finally:
        trainer_module.StepTimer = StepTimer


def _sequenced_splits(test_data):
    """(train, val, test) of the sequenced cell: 1,301 and 301 scenes of at
    most 5 pedestrians, and the test split of steps 3-4."""
    from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data

    return (make_synthetic_data(n_scenes=TRAIN_SCENES, max_peds=5, seed=1),
            make_synthetic_data(n_scenes=N_SCENES, max_peds=5, seed=2), test_data)


def _train_phase(card, cfgs, test_data, recon, profile_dir):
    """Step 7: the training path of ET-STGCNN, then one epoch of ET-SGCN.
    Returns the launches of fused_recon_metrics on the path."""
    import torch
    from eigentrajectory_tpu_torch.data.batching import SceneBatcher
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for matmul and cuDNN in training")
    splits = _sequenced_splits(test_data)
    train, val, _ = splits
    train_peds = int(train.num_peds_in_seq.sum())
    test_blocks = -(-test_data.num_scenes // EVAL_BATCH)

    launches = 0
    with tempfile.TemporaryDirectory() as ckpt_dir:
        # --- ET-STGCNN, hotel configuration ---
        name = "stgcnn"
        cfg = cfgs[name].replace(checkpoint_dir=ckpt_dir)
        if cfg.batch_size != TRAIN_BATCH or cfg.n_max_peds != N_MAX:
            raise AssertionError(f"{name}: the training cell is {TRAIN_BATCH} x {N_MAX} slots")
        recon.LAUNCHES = recon.RECONSTRUCT_LAUNCHES = 0
        tr = ETTorchTrainer(cfg, tag="smoke", datasets=splits)
        _check_descriptor(name, card, tr, ETTorchTrainer(cfg, tag="smoke-cpu", datasets=splits,
                                                         device="cpu"))
        blocks = list(SceneBatcher(train, cfg.batch_size, True, N_MAX, seed=cfg.seed))
        tail = TRAIN_SCENES % TRAIN_BATCH          # 21 real scenes, 107 padding rows
        if len(blocks) != TRAIN_SCENES // TRAIN_BATCH + 1 or \
                int(blocks[-1].scene_valid.sum()) != tail or tail == 0:
            raise AssertionError("the last block of the epoch must end in padding scenes")
        _check_one_step(name, tr, blocks[0], "first block")
        _check_one_step(name, tr, blocks[-1], "last block")

        with _synced_steps():
            tr.fit(num_epochs=TRAIN_EPOCHS, checkpoint_every=2)
        log = tr.log
        if not all(math.isfinite(v) for v in log["train_loss"] + log["val_loss"]):
            raise AssertionError(f"{name}: non-finite losses {log}")
        if len(log["train_loss"]) != TRAIN_EPOCHS or not log["train_loss"][-1] < log["train_loss"][0]:
            raise AssertionError(f"{name}: the train loss did not fall: {log['train_loss']}")
        path = os.path.join(tr.checkpoint_dir, "model_best.msgpack")
        if not os.path.exists(path):
            raise AssertionError(f"{name}: fit() wrote no model_best.msgpack")
        steps = tr.step_timer.durations[len(blocks):]          # epochs 2 and 3
        epochs = tr.epoch_timer.durations
        step_ms = _median(steps) * 1e3
        print(f"[{card}] {name} fit({TRAIN_EPOCHS}) at {cfg.batch_size}x{N_MAX} slots, "
              f"{train.num_scenes} train scenes ({train_peds} trajectories, {len(blocks)} steps "
              f"an epoch), {val.num_scenes} val scenes: train loss {log['train_loss']}, val loss "
              f"{log['val_loss']}; train step median {step_ms:.3f} ms, min "
              f"{min(steps) * 1e3:.3f} ms, max {max(steps) * 1e3:.3f} ms over the "
              f"{len(steps)} steps of epochs 2-3 (host clock, a synchronize at each end); "
              f"epoch (train + valid) seconds {[round(e, 4) for e in epochs]}; "
              f"{train_peds / _median(epochs[1:]):.1f} trained trajectories/s at the median "
              f"of epochs 2-3", flush=True)

        tr.load_model()
        res = tr.test(eval_batch=EVAL_BATCH)
        torch.cuda.synchronize()
        launches = recon.LAUNCHES
        if launches != test_blocks:
            raise AssertionError(f"{name}: test() after fit() launched fused_recon_metrics "
                                 f"{launches} times for {test_blocks} block(s)")
        if not all(math.isfinite(v) for v in res.values()):
            raise AssertionError(f"{name}: non-finite metrics after training {res}")
        fresh = ETTorchTrainer(cfg, tag="smoke", datasets=splits)
        fresh.load_model()
        before = recon.LAUNCHES
        res_fresh = fresh.test(eval_batch=EVAL_BATCH)
        if res_fresh != res or recon.LAUNCHES - before != test_blocks:
            raise AssertionError(f"{name}: a fresh trainer's test() {res_fresh} vs {res}")
        print(f"{name} test() after fit() and load_model(): {res}, fused_recon_metrics "
              f"launches={launches}; a fresh trainer that loads model_best.msgpack gives the "
              f"same means exactly", flush=True)

        resumed = ETTorchTrainer(cfg, tag="smoke", datasets=splits)
        resumed.fit(num_epochs=TRAIN_EPOCHS, resume=True)
        ran = len(resumed.epoch_timer.durations)
        last, want = resumed.log["train_loss"][-1], log["train_loss"][-1]
        if ran != 1 or len(resumed.log["train_loss"]) != TRAIN_EPOCHS or \
                resumed.log["train_loss"][:2] != log["train_loss"][:2] or \
                not abs(last - want) <= 1e-3 * abs(want):
            raise AssertionError(f"{name}: resume ran {ran} epochs, log {resumed.log} vs {log}")
        print(f"[{card}] {name} fit(resume=True) from the state after epoch 2 ran epoch 3 only: "
              f"train loss {last:.8f} (straight run {want:.8f}), {resumed.epoch_timer.durations[0]:.4f} s "
              f"with the plain step timer (no synchronize a step)", flush=True)

        _step_parts(card, name, tr, epoch=TRAIN_EPOCHS)
        if profile_dir is not None:
            _profile_train(card, name, tr, TRAIN_EPOCHS + 1, profile_dir)

        # --- ET-SGCN, zara1 configuration: one epoch ---
        name = "sgcn"
        cfg = cfgs[name].replace(checkpoint_dir=ckpt_dir)
        tr = ETTorchTrainer(cfg, tag="smoke", datasets=splits)
        t0 = time.perf_counter()
        tr.init_descriptor()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        with _synced_steps():
            tr.fit(num_epochs=1)
        if not all(math.isfinite(v) for v in tr.log["train_loss"] + tr.log["val_loss"]):
            raise AssertionError(f"{name}: non-finite losses {tr.log}")
        tr.load_model()
        before = recon.LAUNCHES
        res = tr.test(eval_batch=EVAL_BATCH)
        if recon.LAUNCHES - before != test_blocks or \
                not all(math.isfinite(v) for v in res.values()):
            raise AssertionError(f"{name}: test() after one epoch: {res}")
        steps = tr.step_timer.durations
        print(f"[{card}] {name} init_descriptor() {init_s:.3f} s, one epoch at "
              f"{cfg.batch_size}x{N_MAX} slots: train loss {tr.log['train_loss']}, val loss "
              f"{tr.log['val_loss']}; train step median {_median(steps) * 1e3:.3f} ms over "
              f"{len(steps)} steps (the first included), epoch "
              f"{tr.epoch_timer.durations[0]:.3f} s; test() {res}", flush=True)
    return launches


def _packed_test(name, tr, recon, p_eval, n_batches, eval_ped_batch=EVAL_PED_BATCH):
    """test(eval_ped_batch) of a collated trainer on the card with the launch
    count reset just before it; the kernel must run once a packed batch, at
    N = P. Returns (means, launches)."""
    import torch
    from eigentrajectory_tpu_torch.train import trainer as trainer_module

    shapes, wrapper = [], trainer_module.fused_recon_metrics

    def noting(c_m, *rest):
        shapes.append(tuple(c_m.shape))
        return wrapper(c_m, *rest)

    trainer_module.fused_recon_metrics = noting
    try:
        recon.LAUNCHES = recon.RECONSTRUCT_LAUNCHES = 0
        res = tr.test(eval_ped_batch=eval_ped_batch)
        torch.cuda.synchronize()
        launches = recon.LAUNCHES
    finally:
        trainer_module.fused_recon_metrics = wrapper
    if launches != n_batches or shapes != [(K, p_eval, S)] * n_batches:
        raise AssertionError(f"{name} test(): fused_recon_metrics launched {launches} times at "
                             f"{shapes}, expected once for each of {n_batches} packed batches "
                             f"at N = {p_eval}")
    if not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"{name}: non-finite metrics {res}")
    return res, launches


def _collated_splits():
    """(train, val, test) of scenes of 2-20 pedestrians: 1,301, 301 and 301
    scenes."""
    from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data

    return tuple(make_synthetic_data(n_scenes=n, max_peds=COLLATED_MAX_PEDS, seed=seed)
                 for n, seed in ((TRAIN_SCENES, 1), (N_SCENES, 2), (N_SCENES, 0)))


def _collated_phase(card, recon, profile_dir):
    """Step 8: the collated regime. Returns the launches of both kernels on
    its paths and the kernels' max abs errors at the collated shape."""
    import numpy as np
    import torch
    from eigentrajectory_tpu_torch.config import load_config
    from eigentrajectory_tpu_torch.data.batching import CollatedBatcher
    from eigentrajectory_tpu_torch.inference import ETPredictor
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    splits = _collated_splits()
    train, val, test = splits
    n_peds, train_peds = int(test.num_peds_in_seq.sum()), int(train.num_peds_in_seq.sum())
    p_eval = EVAL_PED_BATCH - 1 + test.max_peds_per_scene
    n_batches = len(CollatedBatcher(test, EVAL_PED_BATCH, False))
    print(f"collated splits: test {test.num_scenes} scenes / {n_peds} peds (scenes of "
          f"{test.num_peds_in_seq.min()}-{test.max_peds_per_scene}), train {train.num_scenes} / "
          f"{train_peds}, val {val.num_scenes} / {int(val.num_peds_in_seq.sum())}; test() packs "
          f"{n_batches} batches of P = {p_eval} slots", flush=True)

    # --- 1. both kernels at the collated shape, checked and timed ---
    case = _case(p_eval, seed=21)
    err, rerr, _, _ = _check_pair(recon, case, "collated shape")
    for spec in _timed_kernels(case, case):
        _kernel_times(recon, card, *spec)
    print(f"(at N = {p_eval} the rotating input sets fit in the L2: the cold-cache method "
          f"reads an L2-warm kernel here)", flush=True)

    cfgs = {name: load_config(os.path.join(REPO, "configs", path), checkpoint_dir=CKPT_DIR)
            for name, path in COLLATED_MODELS}
    recon_metrics_launches = reconstruct_launches = 0

    # --- 2. ET-PECNet from the univ checkpoint: test() and predict() ---
    name = "pecnet"
    tr = ETTorchTrainer(cfgs[name], tag="parity", datasets=splits)
    tr.load_model()
    tr_cpu = ETTorchTrainer(cfgs[name], tag="parity", datasets=splits, device="cpu")
    tr_cpu.load_model()
    res, n = _packed_test(name, tr, recon, p_eval, n_batches)
    recon_metrics_launches += n
    res_cpu = tr_cpu.test(eval_ped_batch=EVAL_PED_BATCH)
    print(f"{name} test() on the card: {res}, fused_recon_metrics launches={n} at N={p_eval}; "
          f"on the CPU: {res_cpu}", flush=True)
    for key, want in res_cpu.items():
        if not abs(res[key] - want) <= ATOL + RTOL * abs(want):
            raise AssertionError(f"{name} {key}: card {res[key]} vs CPU {want}")
    whole = (test.obs_traj, np.repeat(np.arange(N_SCENES), test.num_peds_in_seq))
    requests = {"(a)": (_walkers(5, seed=11), np.zeros(5, np.int64)),
                "(b)": whole,
                "(c)": (_walkers(150, seed=13), np.zeros(150, np.int64))}
    predictor, n = _serve(name, cfgs[name], splits, requests, loose=((name, "(c)"),))
    reconstruct_launches += n
    walls = {
        f"test_{name}": (_host_times(
            lambda: tr.test(eval_ped_batch=EVAL_PED_BATCH), card,
            f"{name} test() ({n_peds} peds in {n_batches} packed batches of {p_eval} slots)",
            n_peds), lambda: tr.test(eval_ped_batch=EVAL_PED_BATCH)),
        f"predict_{name}": (_host_times(
            lambda: predictor.predict(*whole), card,
            f"{name} predict() request (b) ({n_peds} peds in {N_SCENES}x{BUCKET} slots)",
            n_peds), lambda: predictor.predict(*whole))}
    if profile_dir is not None:
        for label, (wall_s, fn) in walls.items():
            _profile(label, fn, card, wall_s, profile_dir)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        # --- 3. ET-PECNet training ---
        cfg = cfgs[name].replace(checkpoint_dir=ckpt_dir)
        tr = ETTorchTrainer(cfg, tag="smoke", datasets=splits)
        p_max = TRAIN_BATCH - 1 + COLLATED_MAX_PEDS
        if cfg.batch_size != TRAIN_BATCH or tr.p_max != p_max:
            raise AssertionError(f"{name}: the training cell packs {TRAIN_BATCH} peds into "
                                 f"{p_max} slots, not {cfg.batch_size} into {tr.p_max}")
        init = _check_descriptor(name, card, tr, ETTorchTrainer(cfg, tag="smoke-cpu",
                                                                datasets=splits, device="cpu"))
        first = next(iter(tr.train_batches(0)))
        _check_one_step(name, tr, first, "first packed batch")
        with _synced_steps():
            tr.fit(num_epochs=COLLATED_EPOCHS)
        log = tr.log
        if len(log["train_loss"]) != COLLATED_EPOCHS or \
                not all(math.isfinite(v) for v in log["train_loss"] + log["val_loss"]):
            raise AssertionError(f"{name}: losses {log}")
        if not os.path.exists(os.path.join(tr.checkpoint_dir, "model_best.msgpack")):
            raise AssertionError(f"{name}: fit() wrote no model_best.msgpack")
        batches = [list(tr.train_batches(e)) for e in range(COLLATED_EPOCHS)]
        per_epoch = [sum(int(b.ped_valid.sum()) for b in bs) for bs in batches]
        steps = tr.step_timer.durations[len(batches[0]):]        # the second epoch
        epochs = tr.epoch_timer.durations
        print(f"[{card}] {name} fit({COLLATED_EPOCHS}) packing {cfg.batch_size} peds into "
              f"{tr.p_max} slots, {train.num_scenes} train scenes ({per_epoch} trajectories "
              f"in the epochs' packed batches, the short last one dropped): train loss "
              f"{log['train_loss']}, val loss {log['val_loss']}; train step median "
              f"{_median(steps) * 1e3:.3f} ms, min {min(steps) * 1e3:.3f} ms, max "
              f"{max(steps) * 1e3:.3f} ms over the {len(steps)} steps of epoch 2 (host clock, "
              f"a synchronize at each end); epoch (train + valid) seconds "
              f"{[round(e, 4) for e in epochs]}; {per_epoch[-1] / epochs[-1]:.1f} trained "
              f"trajectories/s in epoch 2; init_descriptor() {init['total_s']:.3f} s",
              flush=True)
        if profile_dir is not None:
            _profile_train(card, name, tr, COLLATED_EPOCHS, profile_dir)
        tr.load_model()
        res, n = _packed_test(name, tr, recon, p_eval, n_batches)
        recon_metrics_launches += n
        fresh = ETTorchTrainer(cfg, tag="smoke", datasets=splits)
        fresh.load_model()
        res_fresh = fresh.test(eval_ped_batch=EVAL_PED_BATCH)
        if res_fresh != res:
            raise AssertionError(f"{name}: a fresh trainer's test() {res_fresh} vs {res}")
        print(f"{name} test() after fit() and load_model(): {res}, fused_recon_metrics "
              f"launches={n}; a fresh trainer that loads model_best.msgpack gives the same "
              f"means exactly", flush=True)

        # --- 4. ET-LB-EBM from random weights: one epoch, test(), predict() ---
        name = "lbebm"
        cfg = cfgs[name].replace(checkpoint_dir=ckpt_dir)
        tr = ETTorchTrainer(cfg, tag="smoke", datasets=splits)
        tr.init_descriptor()
        with _synced_steps():
            tr.fit(num_epochs=1)
        if not all(math.isfinite(v) for v in tr.log["train_loss"] + tr.log["val_loss"]):
            raise AssertionError(f"{name}: non-finite losses {tr.log}")
        tr.load_model()
        res, n = _packed_test(name, tr, recon, p_eval, n_batches)
        recon_metrics_launches += n
        recon.LAUNCHES = recon.RECONSTRUCT_LAUNCHES = 0
        futures = ETPredictor(tr).predict(*whole)
        torch.cuda.synchronize()
        n = recon.RECONSTRUCT_LAUNCHES
        if n != 1 or futures.shape != (S, n_peds, T, 2) or not np.isfinite(futures).all():
            raise AssertionError(f"{name} predict() (b): {n} launches, {futures.shape}")
        reconstruct_launches += n
        steps = tr.step_timer.durations
        print(f"[{card}] {name} one epoch: train loss {tr.log['train_loss']}, val loss "
              f"{tr.log['val_loss']}; train step median {_median(steps) * 1e3:.3f} ms over "
              f"{len(steps)} steps (the first included), epoch {tr.epoch_timer.durations[0]:.3f} "
              f"s; test() {res} with fused_recon_metrics launches={n_batches}; "
              f"predict() (b) finite, fused_reconstruct launches={n}", flush=True)
    return recon_metrics_launches, reconstruct_launches, err, rerr


def _agentformer_phase(card, recon, attention, seq_data, profile_dir):
    """Step 9: ET-AgentFormer (zara2 configuration), then the reference
    import. Returns the launches of both recon kernels on its paths, the
    kernels' max abs errors at its packed shape, and the attention kernel's
    row: step 9b's measurements and error, and its launches on the main
    paths (the packed test() and predict() at AF_BUCKET)."""
    import numpy as np
    import torch
    from eigentrajectory_tpu_torch.config import load_config
    from eigentrajectory_tpu_torch.data.batching import CollatedBatcher
    from eigentrajectory_tpu_torch.interop import import_checkpoint_to_trainer
    from eigentrajectory_tpu_torch.models import agentformer
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    splits = _collated_splits()
    train, _, test = splits
    n_peds = int(test.num_peds_in_seq.sum())
    cap = agentformer.EVAL_PED_CAP
    p_eval = cap - 1 + test.max_peds_per_scene
    n_batches = len(CollatedBatcher(test, cap, False))
    name = "agentformer"
    cfg = load_config(os.path.join(REPO, "configs", AGENTFORMER_CFG), checkpoint_dir=CKPT_DIR)
    recon_metrics_launches = reconstruct_launches = 0
    err, rerr, _, _ = _check_pair(recon, _case(p_eval, seed=31), "agentformer packed shape")

    # --- 1. test() from the zara2 checkpoint, packed to the cap, card vs CPU ---
    tr = ETTorchTrainer(cfg, tag="parity", datasets=splits)
    tr.load_model()
    tr_cpu = ETTorchTrainer(cfg, tag="parity", datasets=splits, device="cpu")
    tr_cpu.load_model()
    (res, n), attn_launches = _fused_attention(
        "packed test()", attention,
        lambda: _packed_test(name, tr, recon, p_eval, n_batches, eval_ped_batch=None))
    recon_metrics_launches += n
    res_cpu = tr_cpu.test()
    tokens = (cfg.k + 2) * p_eval
    print(f"{name} test() on the card: {res}, fused_recon_metrics launches={n} at N={p_eval} "
          f"({n_batches} packed batches of at most {cap} peds, {tokens} encoder tokens a "
          f"batch); on the CPU: {res_cpu}; max |card - CPU| "
          f"{max(abs(res[k] - res_cpu[k]) for k in res):.3e}", flush=True)
    for key, want in res_cpu.items():
        if not abs(res[key] - want) <= ATOL + RTOL * abs(want):
            raise AssertionError(f"{name} {key}: card {res[key]} vs CPU {want}")

    # --- 2. predict() at AF_BUCKET slots a scene: (a), (b), (c) ---
    whole = (test.obs_traj, np.repeat(np.arange(N_SCENES), test.num_peds_in_seq))
    requests = {"(a)": (_walkers(5, seed=11), np.zeros(5, np.int64)),
                "(b)": whole,
                "(c)": (_walkers(150, seed=13), np.zeros(150, np.int64))}
    (predictor, n), launches = _fused_attention(
        f"predict() at bucket={AF_BUCKET}", attention,
        lambda: _serve(name, cfg, splits, requests, loose=(), bucket=AF_BUCKET))
    reconstruct_launches += n
    attn_launches += launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    predictor.predict(*whole)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[{card}] {name} predict() (b) at bucket={AF_BUCKET} ({N_SCENES} rows of "
          f"{AF_BUCKET} slots, {(cfg.k + 2) * AF_BUCKET} encoder tokens a row): peak device "
          f"memory {peak / 2**30:.3f} GiB (max_memory_allocated; {before / 2**30:.3f} GiB "
          f"held before the call)", flush=True)
    walls = {
        f"test_{name}": (_host_times(
            lambda: tr.test(), card,
            f"{name} test() ({n_peds} peds in {n_batches} packed batches of {p_eval} slots)",
            n_peds), lambda: tr.test()),
        f"predict_{name}": (_host_times(
            lambda: predictor.predict(*whole), card,
            f"{name} predict() request (b) ({n_peds} peds in {N_SCENES}x{AF_BUCKET} slots)",
            n_peds), lambda: predictor.predict(*whole))}
    if profile_dir is not None:
        for label, (wall_s, fn) in walls.items():
            _profile(label, fn, card, wall_s, profile_dir)
    # --- 9b. the attention kernel: checks, times, the request's peak memory ---
    attn_times, attn_err = _attention_phase(card, attention, tr, whole)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        # --- 3. training at TRAIN_BATCH pedestrians a packed batch ---
        cfg_t = cfg.replace(checkpoint_dir=ckpt_dir)
        straight = ETTorchTrainer(cfg_t, tag="smoke", datasets=splits)
        p_max = TRAIN_BATCH - 1 + COLLATED_MAX_PEDS
        if cfg_t.batch_size != TRAIN_BATCH or straight.p_max != p_max:
            raise AssertionError(f"{name}: the training cell packs {TRAIN_BATCH} peds into "
                                 f"{p_max} slots, not {cfg_t.batch_size} into {straight.p_max}")
        init = _check_descriptor(name, card, straight, ETTorchTrainer(
            cfg_t, tag="smoke-cpu", datasets=splits, device="cpu"))
        first_batch = next(iter(straight.train_batches(0)))
        _check_one_step(name, straight, first_batch, "first packed batch, dropout off",
                        train_mode=False)
        with _synced_steps():
            straight.fit(num_epochs=AF_EPOCHS)
        log = straight.log
        if len(log["train_loss"]) != AF_EPOCHS or \
                not all(math.isfinite(v) for v in log["train_loss"] + log["val_loss"]):
            raise AssertionError(f"{name}: losses {log}")
        n_steps = len(straight.train_batches(0))
        steps = straight.step_timer.durations[n_steps:]          # the second epoch
        epochs = straight.epoch_timer.durations
        per_epoch = sum(int(b.ped_valid.sum()) for b in straight.train_batches(AF_EPOCHS - 1))
        print(f"[{card}] {name} fit({AF_EPOCHS}) with dropout {agentformer.TF_DROPOUT}, packing "
              f"{cfg_t.batch_size} peds into {straight.p_max} slots ({(cfg.k + 2) * p_max} "
              f"encoder tokens), {train.num_scenes} train scenes, {n_steps} steps an epoch: "
              f"train loss {log['train_loss']}, val loss {log['val_loss']}; train step median "
              f"{_median(steps) * 1e3:.3f} ms, min {min(steps) * 1e3:.3f} ms, max "
              f"{max(steps) * 1e3:.3f} ms over the {len(steps)} steps of epoch 2 (host clock, "
              f"a synchronize at each end); epoch (train + valid) seconds "
              f"{[round(e, 4) for e in epochs]}; {per_epoch / epochs[-1]:.1f} trained "
              f"trajectories/s in epoch 2; init_descriptor() {init['total_s']:.3f} s",
              flush=True)

        # fit(1) + resume.pt + fit(AF_EPOCHS): the dropout stream goes on
        first = ETTorchTrainer(cfg_t, tag="smoke-resume", datasets=splits)
        first._set_et(straight.et)
        first.fit(num_epochs=1, checkpoint_every=1, verbose=False)
        resumed = ETTorchTrainer(cfg_t, tag="smoke-resume", datasets=splits)
        resumed.fit(num_epochs=AF_EPOCHS, resume=True, verbose=False)
        gaps = [abs(a - b) / abs(b) for a, b in zip(resumed.log["train_loss"], log["train_loss"])]
        if len(resumed.epoch_timer.durations) != AF_EPOCHS - 1 or \
                len(gaps) != AF_EPOCHS or max(gaps) > 1e-6:
            raise AssertionError(f"{name}: fit(1) + resume gave {resumed.log} against the "
                                 f"straight run's {log}")
        if not torch.equal(resumed.dropout_generator.get_state(),
                           straight.dropout_generator.get_state()):
            raise AssertionError(f"{name}: the resumed dropout stream is not the straight one")
        print(f"[{card}] {name} fit(1) + resume.pt + fit({AF_EPOCHS}) against fit({AF_EPOCHS}): "
              f"train losses {resumed.log['train_loss']} vs {log['train_loss']}, relative gaps "
              f"{[f'{g:.3e}' for g in gaps]} (<= 1e-6); the dropout generators end in the "
              f"same state", flush=True)
        if profile_dir is not None:
            _profile_train(card, name, straight, AF_EPOCHS, profile_dir)

        straight.load_model()
        res, n = _packed_test(name, straight, recon, p_eval, n_batches, eval_ped_batch=None)
        recon_metrics_launches += n
        fresh = ETTorchTrainer(cfg_t, tag="smoke", datasets=splits)
        fresh.load_model()
        res_fresh = fresh.test()
        if res_fresh != res:
            raise AssertionError(f"{name}: a fresh trainer's test() {res_fresh} vs {res}")
        print(f"{name} test() after fit() and load_model(): {res}, fused_recon_metrics "
              f"launches={n}; a fresh trainer that loads model_best.msgpack gives the same "
              f"means exactly", flush=True)

        # --- 4. the reference import: ET-SGCN's model_best.pth, card vs CPU ---
        snapshot = os.path.join(REPO, "benchmarks", "ref_resume", "sgcn-zara1.pt")
        # The snapshot (a file of this repository) also holds numpy RNG
        # states, which the restricted unpickler refuses; the state dict in
        # it is read by the import itself, restricted.
        blob = torch.load(snapshot, map_location="cpu", weights_only=False)["best_model"]
        pth = os.path.join(ckpt_dir, "model_best.pth")
        with open(pth, "wb") as f:
            f.write(blob)
        sgcn_cfg = load_config(os.path.join(REPO, "configs", "eigentrajectory-sgcn-zara1.json"),
                               checkpoint_dir=ckpt_dir, n_max_peds=N_MAX)
        seq_splits = (seq_data,) * 3
        imported = import_checkpoint_to_trainer(sgcn_cfg, pth, "imported", datasets=seq_splits)
        imported_cpu = ETTorchTrainer(sgcn_cfg, tag="imported", datasets=seq_splits,
                                      device="cpu")
        imported_cpu.load_model()
        _, n = _check_test("sgcn imported from the reference's model_best.pth", imported,
                           imported_cpu, recon)
        recon_metrics_launches += n
    return (recon_metrics_launches, reconstruct_launches, err, rerr,
            (attn_times, attn_err, attn_launches))


def _near_band_edges(probe):
    """Run `probe` (a CPU run of ET-DMRGCN) with its pre-hook noting the
    adjacency, and count the entries that lie within 4 ulps of a band edge
    (above 0 for the edge at 0): where f32 rounding can move an edge to
    another band."""
    import torch
    from eigentrajectory_tpu_torch.models import dmrgcn

    seen, prepare = [], dmrgcn.prepare

    def noting(*args):
        out = prepare(*args)
        seen.append(out[1].float())
        return out

    dmrgcn.prepare = noting
    try:
        probe()
    finally:
        dmrgcn.prepare = prepare
    count = 0
    for a in seen:
        for r, split in enumerate(dmrgcn.SPLIT):
            x = a[:, r]
            for edge in split:
                e = torch.tensor(edge, dtype=torch.float32)
                ulp = float(torch.nextafter(e, torch.tensor(float("inf"))) - e)
                count += int(((x - edge).abs() <= 4 * ulp).logical_and(x != 0).sum())
    return count


@contextmanager
def _band_edges_on_failure(name, probe):
    """Re-raise a failed check of ET-DMRGCN with the count of adjacency
    entries within 4 ulps of a band edge in the failing case."""
    try:
        yield
    except AssertionError as e:
        if name != "dmrgcn":
            raise
        raise AssertionError(f"{e}\n[{name}: {_near_band_edges(probe)} adjacency entries of "
                             f"this case lie within 4 ulps of a band edge]") from e


def _multirelational_phase(card, recon, seq_data, profile_dir):
    """Step 10: ET-DMRGCN and ET-Graph-TERN from the reference's eth weights
    on the sequenced splits of steps 4 and 7. Returns the launches of both
    kernels on their paths.

    No kernel check of its own: fused_recon_metrics runs here once a test()
    block at N = EVAL_BATCH * N_MAX = 18,240, the eval shape of step 2's
    `_check_pair`, and fused_reconstruct on the pedestrians of requests (a),
    (b) and (c), the requests that step 4 holds card against CPU for
    ET-STGCNN and ET-SGCN (step 2 holds the kernel against its plain version
    at the serving shape and at the tile edges).
    """
    import numpy as np
    import torch
    from eigentrajectory_tpu_torch.config import load_config
    from eigentrajectory_tpu_torch.data.batching import SceneBatcher
    from eigentrajectory_tpu_torch.inference import ETPredictor
    from eigentrajectory_tpu_torch.interop import import_checkpoint_to_trainer
    from eigentrajectory_tpu_torch.models.common import draw_edge_keeps
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    splits = _sequenced_splits(seq_data)
    train, val, test = splits
    n_peds, train_peds = int(test.num_peds_in_seq.sum()), int(train.num_peds_in_seq.sum())
    test_blocks = -(-test.num_scenes // EVAL_BATCH)
    whole = (test.obs_traj, np.repeat(np.arange(N_SCENES), test.num_peds_in_seq))
    requests = {"(a)": (_walkers(5, seed=11), np.zeros(5, np.int64)),
                "(b)": whole,
                "(c)": (_walkers(150, seed=13), np.zeros(150, np.int64))}
    recon_metrics_launches = reconstruct_launches = 0
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for name in MULTIREL_MODELS:
            cfg = load_config(os.path.join(REPO, "configs", f"eigentrajectory-{name}-eth.json"),
                              checkpoint_dir=ckpt_dir, n_max_peds=N_MAX)
            if cfg.batch_size != TRAIN_BATCH:
                raise AssertionError(f"{name}: the training cell is {TRAIN_BATCH} x {N_MAX} slots")
            # --- 1. the reference's eth weights through the import ---
            snapshot = os.path.join(REPO, "benchmarks", "ref_resume", f"{name}-eth.pt")
            # The snapshot (a file of this repository) also holds numpy RNG
            # states, which the restricted unpickler refuses; the state dict
            # in it is read by the import itself, restricted.
            blob = torch.load(snapshot, map_location="cpu", weights_only=False)["best_model"]
            pth = os.path.join(ckpt_dir, f"{name}-model_best.pth")
            with open(pth, "wb") as f:
                f.write(blob)
            tr = import_checkpoint_to_trainer(cfg, pth, "imported", datasets=splits)
            tr_cpu = ETTorchTrainer(cfg, tag="imported", datasets=splits, device="cpu")
            tr_cpu.load_model()

            # --- 2. test(): one block of EVAL_BATCH x N_MAX slots, card vs CPU ---
            with _band_edges_on_failure(name, lambda: tr_cpu.test(eval_batch=EVAL_BATCH)):
                res, n = _check_test(f"{name} (eth weights)", tr, tr_cpu, recon)
            if n != test_blocks:
                raise AssertionError(f"{name}: test() launched fused_recon_metrics {n} times "
                                     f"for {test_blocks} block(s)")
            recon_metrics_launches += n

            # --- 3. predict() (a), (b), (c) at BUCKET slots a scene ---
            # (c), 150 pedestrians in one scene, is held to the float64 run.
            probe_p = ETPredictor(tr_cpu, bucket=BUCKET)
            with _band_edges_on_failure(name, lambda: [probe_p.predict(*r)
                                                       for r in requests.values()]):
                predictor, n = _serve(name, cfg, splits, requests, loose=((name, "(c)"),),
                                      tag="imported")
            reconstruct_launches += n
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            predictor.predict(*whole)
            torch.cuda.synchronize()
            print(f"[{card}] {name} predict() (b) ({N_SCENES} rows of {BUCKET} slots): peak device "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                  f"(max_memory_allocated; {held / 2**30:.3f} GiB held before the call)",
                  flush=True)
            walls = {
                f"test_{name}": (_host_times(
                    lambda: tr.test(eval_batch=EVAL_BATCH), card,
                    f"{name} test() ({n_peds} peds in {EVAL_BATCH}x{N_MAX} slots)", n_peds),
                    lambda: tr.test(eval_batch=EVAL_BATCH)),
                f"predict_{name}": (_host_times(
                    lambda: predictor.predict(*whole), card,
                    f"{name} predict() request (b) ({n_peds} peds in {N_SCENES}x{BUCKET} slots)",
                    n_peds), lambda: predictor.predict(*whole))}
            if profile_dir is not None:
                for label, (wall_s, fn) in walls.items():
                    _profile(label, fn, card, wall_s, profile_dir)

            # --- 4. training from the seed's weights: descriptor, one step ---
            straight = ETTorchTrainer(cfg, tag="smoke", datasets=splits)
            init = _check_descriptor(name, card, straight, ETTorchTrainer(
                cfg, tag="smoke-cpu", datasets=splits, device="cpu"))
            blocks = list(SceneBatcher(train, cfg.batch_size, True, N_MAX, seed=cfg.seed))
            # The same DropEdge draws on the three devices, from a CPU
            # generator: the card's own stream stays at its seed for fit().
            draws = torch.Generator().manual_seed(cfg.seed + 1)
            for batch, label in ((blocks[0], "first block"), (blocks[-1], "last block")):
                keeps = draw_edge_keeps(straight.model, draws, TRAIN_BATCH, N_MAX)
                kept = sum(float(k.float().mean()) for k in keeps) / len(keeps)

                def probe(batch=batch):
                    cpu = _copy_trainer(straight, "cpu", torch.float32)
                    with torch.no_grad():
                        cpu._chunk_loss(*cpu._to_device(batch))

                with _band_edges_on_failure(name, probe):
                    _check_one_step(name, straight, batch,
                                    f"{label}, DropEdge on ({len(keeps)} sites, kept share "
                                    f"{kept:.4f})", edge_keeps=keeps)

            if name == "graphtern":
                # --- 5b. ET-Graph-TERN: one epoch, test() ---
                with _synced_steps():
                    straight.fit(num_epochs=1)
                straight.load_model()
                before = recon.LAUNCHES
                res = straight.test(eval_batch=EVAL_BATCH)
                n = recon.LAUNCHES - before
                values = list(res.values()) + straight.log["train_loss"] + straight.log["val_loss"]
                if n != test_blocks or not all(math.isfinite(v) for v in values):
                    raise AssertionError(f"{name}: one epoch {straight.log}, test() {res}, "
                                         f"{n} launches")
                recon_metrics_launches += n
                steps = straight.step_timer.durations
                print(f"[{card}] {name} one epoch at {cfg.batch_size}x{N_MAX} slots: train loss "
                      f"{straight.log['train_loss']}, val loss {straight.log['val_loss']}; train "
                      f"step median {_median(steps) * 1e3:.3f} ms over {len(steps)} steps (the "
                      f"first included), epoch {straight.epoch_timer.durations[0]:.3f} s; "
                      f"init_descriptor() {init['total_s']:.3f} s; test() {res}, "
                      f"fused_recon_metrics launches={n}", flush=True)
                continue

            # --- 5a. ET-DMRGCN: fit(2), a resume, the checkpoint round trip ---
            with _synced_steps():
                straight.fit(num_epochs=MULTIREL_EPOCHS)
            log = straight.log
            if len(log["train_loss"]) != MULTIREL_EPOCHS or \
                    not all(math.isfinite(v) for v in log["train_loss"] + log["val_loss"]):
                raise AssertionError(f"{name}: losses {log}")
            steps = straight.step_timer.durations[len(blocks):]      # the second epoch
            epochs = straight.epoch_timer.durations
            print(f"[{card}] {name} fit({MULTIREL_EPOCHS}) with DropEdge 0.8 at "
                  f"{cfg.batch_size}x{N_MAX} slots, {train.num_scenes} train scenes "
                  f"({train_peds} trajectories, {len(blocks)} steps an epoch), {val.num_scenes} "
                  f"val scenes: train loss {log['train_loss']}, val loss {log['val_loss']}; train "
                  f"step median {_median(steps) * 1e3:.3f} ms, min {min(steps) * 1e3:.3f} ms, "
                  f"max {max(steps) * 1e3:.3f} ms over the {len(steps)} steps of epoch 2 (host "
                  f"clock, a synchronize at each end); epoch (train + valid) seconds "
                  f"{[round(e, 4) for e in epochs]}; {train_peds / epochs[-1]:.1f} trained "
                  f"trajectories/s in epoch 2; init_descriptor() {init['total_s']:.3f} s",
                  flush=True)

            first = ETTorchTrainer(cfg, tag="smoke-resume", datasets=splits)
            first._set_et(straight.et)
            first.fit(num_epochs=1, checkpoint_every=1, verbose=False)
            resumed = ETTorchTrainer(cfg, tag="smoke-resume", datasets=splits)
            resumed.fit(num_epochs=MULTIREL_EPOCHS, resume=True, verbose=False)
            gaps = [abs(a - b) / abs(b) for a, b in zip(resumed.log["train_loss"],
                                                        log["train_loss"])]
            if len(resumed.epoch_timer.durations) != MULTIREL_EPOCHS - 1 or \
                    len(gaps) != MULTIREL_EPOCHS or max(gaps) > 1e-6:
                raise AssertionError(f"{name}: fit(1) + resume gave {resumed.log} against the "
                                     f"straight run's {log}")
            if not torch.equal(resumed.dropout_generator.get_state(),
                               straight.dropout_generator.get_state()):
                raise AssertionError(f"{name}: the resumed DropEdge stream is not the straight one")
            print(f"[{card}] {name} fit(1) + resume.pt + fit({MULTIREL_EPOCHS}) against "
                  f"fit({MULTIREL_EPOCHS}): train losses {resumed.log['train_loss']} vs "
                  f"{log['train_loss']}, relative gaps {[f'{g:.3e}' for g in gaps]} (<= 1e-6); "
                  f"the dropout generators end in the same state", flush=True)

            straight.load_model()
            before = recon.LAUNCHES
            res = straight.test(eval_batch=EVAL_BATCH)
            n = recon.LAUNCHES - before
            if n != test_blocks or not all(math.isfinite(v) for v in res.values()):
                raise AssertionError(f"{name}: test() after fit(): {res}, {n} launches")
            recon_metrics_launches += n
            fresh = ETTorchTrainer(cfg, tag="smoke", datasets=splits)
            fresh.load_model()
            res_fresh = fresh.test(eval_batch=EVAL_BATCH)
            if res_fresh != res:
                raise AssertionError(f"{name}: a fresh trainer's test() {res_fresh} vs {res}")
            print(f"{name} test() after fit() and load_model(): {res}, fused_recon_metrics "
                  f"launches={n}; a fresh trainer that loads model_best.msgpack gives the same "
                  f"means exactly", flush=True)
            _step_parts(card, name, straight, epoch=MULTIREL_EPOCHS)
            if profile_dir is not None:
                _profile_train(card, name, straight, MULTIREL_EPOCHS + 1, profile_dir)
    return recon_metrics_launches, reconstruct_launches


def _relabel_bound_ms(merge, valid):
    """(ms, "bytes" or "operations") for the group relabel on these inputs:
    the strictly lower triangle of merge (the rest is zero by contract, and
    neither the function nor the kernel reads it) and valid read once,
    ranks and n_groups written once; per scene N(N-1)/2 tests of a merge
    bit, N compares and selects a row holding a merge (its merges chain
    through the row's own label and collapse into one N-wide step, see
    group_relabel.cu), and the 2N-long presence and prefix pass, counted
    against the f32 rate."""
    b, n = valid.shape
    rows = int(merge.tril(-1).any(dim=-1).sum())
    return _bound(b * n * (n - 1) // 2 + valid.numel(), 4 * b * n + 4 * b,
                  b * n * (n - 1) // 2 + rows * n + b * 4 * n)


def _chain_depth(merge):
    """(the kernel's chain on these inputs, a walk of every merge): the
    largest, over the block's scenes, of rows holding a merge (one step a
    row, see group_relabel.cu), and of rows holding a merge plus merges
    (each merge changes a label: slot r's own)."""
    tri = merge.tril(-1)
    rows = tri.any(dim=-1).sum(dim=-1)
    return int(rows.max()), int((rows + tri.sum(dim=(-2, -1))).max())


def _relabel_times(group, card, merge, valid, plain_iters, label="main path"):
    """The relabel's row of measurements at one shape: device ms by CUDA
    graph replay of GRAPH_LAUNCHES_EVAL launches on one input set (the
    inputs, ~1 MB at (320, 57), stay in L2 whatever the method: the kernel
    is a chain of merges, not a stream of bytes), wrapper-loop ms, the plain
    version's ms on the card, the bound, the serial depth of the pairs'
    loop (N(N-1)/2) and the kernel's chain depth."""
    b, n = valid.shape
    args = [(merge, valid)]
    ms = _replay_ms(_capture(group.group_ranks, args, GRAPH_LAUNCHES_EVAL), GRAPH_LAUNCHES_EVAL)
    call_ms = _call_ms(lambda: group.group_ranks(merge, valid), 50)
    plain_ms = _call_ms(lambda: group.group_ranks_plain(merge, valid), plain_iters)
    bound_ms, bound_by = _relabel_bound_ms(merge, valid)
    depth, (chain, walk) = n * (n - 1) // 2, _chain_depth(merge)
    print(f"[{card}] group_relabel {label} B={b} N={n}: device {ms:.4f} ms (graph replay), "
          f"wrapper loop {call_ms:.4f} ms a call; plain version on the card {plain_ms:.4f} ms; "
          f"bound {bound_ms:.6f} ms ({bound_by}), {bound_ms / ms:.2%} of it reached; serial "
          f"depth {depth} steps a scene, chain depth {chain} (rows holding a merge, the most "
          f"of a scene; rows + merges {walk}); {int(merge.sum())} merges fired in the block",
          flush=True)
    return dict(ms=ms, kernel_ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, serial_depth=depth, chain_depth=chain,
                rows_plus_merges=walk, shape=[b, n])


def _all_merge(gpgraph_common, b, n):
    """(merge, valid) on the card where every valid pair merges: N(N-1)/2
    merges a full scene, the kernel's longest chain. Scene i has i % 4
    padded slots."""
    import torch

    valid = torch.arange(n)[None] < (n - torch.arange(b) % 4)[:, None]
    merge = gpgraph_common.merge_mask(torch.zeros((b, n, n)), torch.tensor(0.5), valid)
    return merge.contiguous().cuda(), valid.cuda()


def _relabel_check(group, merge, valid, label):
    """The kernel on the card against its plain version on the same inputs,
    bit for bit (ranks and group counts are integers); returns max |card -
    plain| over both outputs. Not a main-path launch: the caller keeps
    these out of the count."""
    import torch

    got = group.group_ranks(merge, valid)
    torch.cuda.synchronize()
    want = group.group_ranks_plain(merge.cpu(), valid.cpu())
    err = 0
    for a, w, what in zip(got, want, ("ranks", "n_groups")):
        if a.dtype != torch.int32 or a.shape != w.shape:
            raise AssertionError(f"group_relabel {label}: {what} {a.dtype} {tuple(a.shape)}")
        gap = (a.cpu().long() - w.long()).abs()
        err = max(err, int(gap.max()) if gap.numel() else 0)
        if gap.any():
            raise AssertionError(f"group_relabel {label}: {what} differ from the plain version "
                                 f"at {int((gap > 0).sum())} entries, by up to {err}")
    b, n = valid.shape
    print(f"group_relabel {label} (B={b}, N={n}, {int(merge.sum())} merges, "
          f"{int(want[1].sum())} groups): bit-equal to its plain version, max |card - plain| "
          f"{err}", flush=True)
    return float(err)


@contextmanager
def _noting_relabels(gpgraph_common):
    """Within the block, note the (merge, valid, th, dist_mat) of every call
    of the relabel that the GP-Graph models make."""
    seen = []
    find = gpgraph_common.find_group_indices

    def noting(dist_mat, th, valid):
        seen.append((gpgraph_common.merge_mask(dist_mat, th, valid).contiguous(),
                     valid.contiguous(), float(th), dist_mat))
        return find(dist_mat, th, valid)

    gpgraph_common.find_group_indices = noting
    try:
        yield seen
    finally:
        gpgraph_common.find_group_indices = find


def _group_counts(merge, valid):
    """Stream by stream: valid pedestrians (streams 1 and 3), groups (the
    pooled stream 2's slots), groups of two or more, singletons."""
    from eigentrajectory_tpu_torch.ops import group

    ranks, n_groups = group.group_ranks_plain(merge.cpu(), valid.cpu())
    v = valid.cpu()
    real = int((n_groups - (~v).sum(dim=1)).sum())
    sizes = [_group_sizes(r[m]) for r, m in zip(ranks, v) if m.any()]
    multi = sum(int((s >= 2).sum()) for s in sizes)
    single = sum(int((s == 1).sum()) for s in sizes)
    return {"peds (streams 1, 3)": int(v.sum()), "groups (stream 2)": real,
            "groups of 2+": multi, "singletons": single}


def _group_sizes(ranks):
    import torch

    counts = torch.bincount(ranks.long())
    return counts[counts > 0]


def _zone_counts(tr, batch_or_args):
    """Implicit: pedestrians in each zone over the valid slots of a block."""
    import torch
    from eigentrajectory_tpu_torch.etspace.facade import et_forward
    from eigentrajectory_tpu_torch.models import implicit

    obs, _, valid, scene_info = batch_or_args
    seen = []

    def fn(c_obs, obs_ori, aux):
        v, ok = implicit.prepare(c_obs, obs_ori, aux)
        seen.append((implicit.zones(v), ok, v[:, 0, 0, :]))
        b, _, n = c_obs.shape
        return c_obs.new_zeros((b, tr.cfg.k, n, tr.cfg.num_samples))

    with torch.no_grad():
        et_forward(tr.et, fn, obs, valid, tr.cfg.static_dist,
                   aux=tr.make_aux(valid, scene_info), return_coefficients=True)
    zone, ok, c0 = seen[0]
    return [int(((zone == i) & ok).sum()) for i in range(4)], c0[ok]


def _near_knife_edges(name, tr_cpu, batch_or_args):
    """The count of decisions within 4 ulps of their edge on a CPU run of
    this case: GP-Graph pair distances against th, Implicit |c_0| against
    the bin edges."""
    import torch
    from eigentrajectory_tpu_torch.models import gpgraph_common, implicit

    def ulps(x, edges):
        e = torch.tensor(edges, dtype=torch.float32)
        step = (torch.nextafter(e, torch.tensor(float("inf"))) - e)
        return int(((x.float()[..., None] - e).abs() <= 4 * step).sum())

    if name == "implicit":
        _, c0 = _zone_counts(tr_cpu, batch_or_args)
        return f"{ulps(c0.abs(), implicit.BINS[1:])} |c_0| within 4 ulps of a bin edge"
    with _noting_relabels(gpgraph_common) as seen, torch.no_grad():
        obs, pred, valid, scene_info = batch_or_args
        tr_cpu._chunk_loss(obs, pred, valid, scene_info)
    count = 0
    for merge, valid, th, dist in seen:
        pairs = torch.ones_like(merge).tril(-1) & valid[:, :, None] & valid[:, None, :]
        count += ulps(dist[pairs], [th])
    return f"{count} pair distances within 4 ulps of th"


@contextmanager
def _knife_edges_on_failure(name, tr_cpu, args):
    """Re-raise a failed card-vs-CPU check of a GP-Graph or Implicit model
    with the count of its decisions within 4 ulps of their edge."""
    try:
        yield
    except AssertionError as e:
        raise AssertionError(f"{e}\n[{name}: {_near_knife_edges(name, tr_cpu, args)} in this "
                             f"case]") from e


def _draw_cell_scalars(model):
    """Implicit: draw every cell's global_w and local_w in [0.5, 1.5] from a
    seed. The init's 0 leaves every conv of the cells a zero gradient, which
    a step check would pass whatever the backward did."""
    import torch

    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith((".global_w", ".local_w")):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))


def _assert_cells_learn(name, label, grads, counts):
    """Implicit: the convs of the cells of the zones the block uses, and of
    no other, got a nonzero gradient on the card."""
    used = {i for i, c in enumerate(counts) if c}
    for conv in ("feat", "tpcnn", "ped.feat.conv", "ped.tpcnn.conv"):
        learning = {i for i in range(len(counts))
                    if float(grads[f"cell_{i}.{conv}.weight"].abs().max()) > 0}
        if learning != used or not used:
            raise AssertionError(f"{name} {label}: cells whose {conv} learns {learning}, zones "
                                 f"used {used} ({counts} pedestrians)")
    print(f"{name} {label}: pedestrians by zone {counts}; the convs of cells {sorted(used)} "
          f"have nonzero gradients, those of the others 0", flush=True)


def _set_th(tr, tr_cpu, splits, card):
    """Set GP-Graph's th on both trainers to the midpoint between two
    adjacent distinct pair distances at the 0.3 quantile of the test
    block's, on the CPU: groups form, and no distance lies within rounding
    of th."""
    import numpy as np
    import torch
    from eigentrajectory_tpu_torch.data.batching import SceneBatcher
    from eigentrajectory_tpu_torch.etspace.facade import et_forward

    seen = []
    model = tr_cpu.model

    def fn(c_obs, obs_ori, aux):
        v_abs, _, valid = tr_cpu.baseline.prepare(c_obs, obs_ori, aux)
        seen.append((model.group_gen.distances(v_abs, valid), valid))
        b, _, n = c_obs.shape
        return c_obs.new_zeros((b, tr_cpu.cfg.k, n, tr_cpu.cfg.num_samples))

    batch = next(iter(SceneBatcher(splits[2], EVAL_BATCH, False, N_MAX)))
    obs, _, valid, scene_valid = tr_cpu._to_device(batch)
    with torch.no_grad():
        et_forward(tr_cpu.et, fn, obs, valid, tr_cpu.cfg.static_dist,
                   aux=tr_cpu.make_aux(valid, scene_valid), return_coefficients=True)
    dist, ok = seen[0]
    pairs = torch.ones_like(dist, dtype=torch.bool).tril(-1) & ok[:, :, None] & ok[:, None, :]
    values = np.unique(dist[pairs].numpy())
    i = int(0.3 * (len(values) - 1))
    th = float((values[i] + values[i + 1]) / 2)
    for t in (tr, tr_cpu):
        with torch.no_grad():
            t.model.group_gen.th.fill_(th)
    print(f"[{card}] {tr.cfg.baseline}: th set to {th:.6f}, between the pair distances "
          f"{values[i]:.6f} and {values[i + 1]:.6f} of the test block ({len(values)} distinct)",
          flush=True)
    return th


def _dense_splits():
    """Dense scenes, 2 to N_MAX pedestrians a scene (~30 on average): a
    train split of one block of TRAIN_BATCH scenes and a test split of 128
    scenes, one padded eval block."""
    from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data

    train = make_synthetic_data(n_scenes=TRAIN_BATCH, max_peds=N_MAX, seed=21)
    test = make_synthetic_data(n_scenes=128, max_peds=N_MAX, seed=22)
    return train, test


def _lap(card, name, part, t0):
    """Print the seconds since t0 of one part of step 11; returns now."""
    now = time.perf_counter()
    print(f"[{card}] step 11 {name}: {part} {now - t0:.1f} s", flush=True)
    return now


def _groups_zones_phase(card, recon, group, seq_data, profile_dir):
    """Step 11: ET-GP-Graph-STGCNN, ET-GP-Graph-SGCN and ET-Social-Implicit
    (hotel configurations at their published widths) from the port's seeded
    init on the sequenced splits of steps 4 and 7, and a block of dense
    scenes for them and ET-DMRGCN. Returns (launches of fused_recon_metrics,
    of fused_reconstruct, of group_relabel on the paths, the relabel's
    times at (320, 57) and (301, 128))."""
    import numpy as np
    import torch
    from eigentrajectory_tpu_torch.config import load_config
    from eigentrajectory_tpu_torch.data.batching import SceneBatcher
    from eigentrajectory_tpu_torch.interop import import_checkpoint_to_trainer
    from eigentrajectory_tpu_torch.models import gpgraph_common
    from eigentrajectory_tpu_torch.models.common import draw_edge_keeps
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    t_step = time.perf_counter()
    splits = _sequenced_splits(seq_data)
    train, val, test = splits
    dense_train, dense_test = _dense_splits()
    dense_splits = (dense_train, val, dense_test)
    dense_block = next(iter(SceneBatcher(dense_train, TRAIN_BATCH, True, N_MAX, seed=1)))
    n_peds = int(test.num_peds_in_seq.sum())
    test_blocks = -(-test.num_scenes // EVAL_BATCH)
    whole = (test.obs_traj, np.repeat(np.arange(N_SCENES), test.num_peds_in_seq))
    requests = {"(a)": (_walkers(5, seed=11), np.zeros(5, np.int64)),
                "(b)": whole,
                "(c)": (_walkers(150, seed=13), np.zeros(150, np.int64))}
    print(f"step 11: dense block of {dense_train.num_scenes} train scenes "
          f"({int(dense_train.num_peds_in_seq.sum())} pedestrians, up to {N_MAX} a scene) and "
          f"{dense_test.num_scenes} test scenes ({int(dense_test.num_peds_in_seq.sum())})",
          flush=True)
    launches = {"recon_metrics": 0, "reconstruct": 0, "group": 0}
    noted = {}                                    # relabel inputs of the main path by shape
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for name in GROUP_ZONE_MODELS:
            t_model = t_part = time.perf_counter()
            cfg = load_config(os.path.join(REPO, "configs", f"eigentrajectory-{name}-hotel.json"),
                              checkpoint_dir=ckpt_dir, n_max_peds=N_MAX)
            if cfg.batch_size != TRAIN_BATCH:
                raise AssertionError(f"{name}: the training cell is {TRAIN_BATCH} x {N_MAX} slots")
            # --- 1. descriptor, then a step on the first and on a dense block ---
            tr = ETTorchTrainer(cfg, tag="smoke", datasets=splits)
            tr_cpu = ETTorchTrainer(cfg, tag="smoke-cpu", datasets=splits, device="cpu")
            init = _check_descriptor(name, card, tr, tr_cpu)
            if name == "implicit":
                _draw_cell_scalars(tr.model)
            tr_cpu.model.load_state_dict(tr.model.state_dict())
            tr_cpu._set_et(tr.et)
            if name != "implicit":
                _set_th(tr, tr_cpu, splits, card)
            blocks = list(SceneBatcher(train, cfg.batch_size, True, N_MAX, seed=cfg.seed))
            # GP-Graph-SGCN's step is checked on the first 32 rows of a block
            # (micro_batches 8 divides them): its three CPU steps on a whole
            # block took 43-45 s on the host of an NVIDIA H100 80GB HBM3
            # (PERF.md §6).
            rows = 32 if name == "gpgraphsgcn" else cfg.batch_size
            for batch, label in ((blocks[0], "first block"), (dense_block, "dense block")):
                batch = dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[:rows]
                                                      for f in dataclasses.fields(batch)})
                label = f"{label} ({rows} of its rows)" if rows < cfg.batch_size else label
                args = tr_cpu._to_device(batch)
                with _knife_edges_on_failure(name, tr_cpu, args):
                    grads = _check_one_step(name, tr, batch, f"{label}, micro_batches "
                                            f"{cfg.micro_batches}")
                if name == "implicit":
                    _assert_cells_learn(name, label, grads, _zone_counts(tr_cpu, args)[0])
                t_part = _lap(card, name, f"descriptor and the step on the {label}", t_part)

            # --- 2. fit(1), th kept; the checkpoint the checks below read ---
            group.LAUNCHES = recon.LAUNCHES = 0
            with _synced_steps():
                tr.fit(num_epochs=1, checkpoint_every=1)
            torch.cuda.synchronize()
            n_val = -(-val.num_scenes // cfg.batch_size)
            want = len(blocks) * cfg.micro_batches + n_val if name != "implicit" else 0
            if group.LAUNCHES != want:
                raise AssertionError(f"{name}: fit(1) launched group_relabel {group.LAUNCHES} "
                                     f"times, expected {want}")
            launches["group"] += group.LAUNCHES
            if not all(math.isfinite(v) for v in tr.log["train_loss"] + tr.log["val_loss"]):
                raise AssertionError(f"{name}: losses {tr.log}")
            steps = tr.step_timer.durations
            print(f"[{card}] {name} fit(1) at {cfg.batch_size}x{N_MAX} slots, micro_batches "
                  f"{cfg.micro_batches}: train loss {tr.log['train_loss']}, val loss "
                  f"{tr.log['val_loss']}; train step median {_median(steps) * 1e3:.3f} ms, min "
                  f"{min(steps) * 1e3:.3f} ms, max {max(steps) * 1e3:.3f} ms over {len(steps)} "
                  f"steps (the first included; host clock, a synchronize at each end), epoch "
                  f"{tr.epoch_timer.durations[0]:.3f} s, "
                  f"{int(train.num_peds_in_seq.sum()) / tr.epoch_timer.durations[0]:.1f} trained "
                  f"trajectories/s; group_relabel launches {group.LAUNCHES}; init_descriptor() "
                  f"{init['total_s']:.3f} s", flush=True)
            if name != "implicit":            # th has learned: set it again, clear of ties
                _set_th(tr, _copy_trainer(tr, "cpu", torch.float32), splits, card)
            tr.save_model()
            tr_cpu = ETTorchTrainer(cfg, tag="smoke", datasets=splits, device="cpu")
            tr_cpu.load_model()
            t_part = _lap(card, name, "fit(1)", t_part)

            # --- 3. test(): one block of EVAL_BATCH x N_MAX, card vs CPU; dense block ---
            batch = next(iter(SceneBatcher(test, EVAL_BATCH, False, N_MAX)))
            with _noting_relabels(gpgraph_common) as seen:
                group.LAUNCHES = 0
                with _knife_edges_on_failure(name, tr_cpu, tr_cpu._to_device(batch)):
                    res, n = _check_test(name, tr, tr_cpu, recon)
                n_group = group.LAUNCHES
            if n != test_blocks:
                raise AssertionError(f"{name}: test() launched fused_recon_metrics {n} times")
            launches["recon_metrics"] += n
            if name == "implicit":
                counts, _ = _zone_counts(tr_cpu, tr_cpu._to_device(batch))
                print(f"{name} test() block: pedestrians by zone {counts}", flush=True)
                if sum(c > 0 for c in counts) < 2:
                    raise AssertionError(f"{name}: fewer than two zones used in the test() "
                                         f"block: {counts}")
            else:
                if n_group != test_blocks:
                    raise AssertionError(f"{name}: test() launched group_relabel {n_group} "
                                         f"times for {test_blocks} block(s)")
                launches["group"] += n_group
                merge, valid = seen[0][0], seen[0][1]       # the card's, at (320, 57)
                counts = _group_counts(merge, valid)
                print(f"{name} test() block: {counts}; group_relabel launches {n_group}",
                      flush=True)
                if counts["groups of 2+"] < 1 or counts["singletons"] < 1:
                    raise AssertionError(f"{name}: no grouping in the test() block: {counts}")
                noted.setdefault((EVAL_BATCH, N_MAX), (merge, valid))

            tr_d = ETTorchTrainer(cfg, tag="smoke", datasets=dense_splits)
            tr_d.load_model()
            tr_d_cpu = ETTorchTrainer(cfg, tag="smoke", datasets=dense_splits, device="cpu")
            tr_d_cpu.load_model()
            if name != "implicit":
                _set_th(tr_d, tr_d_cpu, dense_splits, card)
            dense_eval = next(iter(SceneBatcher(dense_test, EVAL_BATCH, False, N_MAX)))
            group.LAUNCHES = 0
            with _knife_edges_on_failure(name, tr_d_cpu, tr_d_cpu._to_device(dense_eval)):
                _, n = _check_test(f"{name} (dense block)", tr_d, tr_d_cpu, recon)
            launches["recon_metrics"] += n
            launches["group"] += group.LAUNCHES
            t_part = _lap(card, name, "test() of both blocks, card and CPU", t_part)

            # --- 4. predict() (a), (b), (c) at BUCKET slots a scene ---
            # GP-Graph-SGCN's request (b) is checked on its first 64 scenes
            # (each scene is a row of its own): the CPU's f32 and f64 runs of
            # the whole took 142.7 s on the host of an NVIDIA H100 80GB HBM3
            # (PERF.md §6). Its whole request (b) runs below, timed.
            checked = requests
            if name == "gpgraphsgcn":
                first = whole[1] < 64
                checked = {**requests, "(b)": (whole[0][first], whole[1][first])}
            with _noting_relabels(gpgraph_common) as seen:
                group.LAUNCHES = 0
                predictor, n = _serve(name, cfg, splits, checked, loose=((name, "(c)"),),
                                      tag="smoke")
                n_group = group.LAUNCHES
            launches["reconstruct"] += n
            if name != "implicit":
                # (a), the two-scene request, (b), (c) on the card; the CPU runs do not launch
                if n_group != 4:
                    raise AssertionError(f"{name}: predict() launched group_relabel {n_group} "
                                         f"times for 4 requests")
                launches["group"] += n_group
                for merge, valid, _, _ in seen:
                    if merge.is_cuda:
                        noted.setdefault(tuple(valid.shape), (merge, valid))
            t_part = _lap(card, name, "predict() (a), (b), (c), card and CPU f32 / f64", t_part)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            predictor.predict(*whole)
            torch.cuda.synchronize()
            print(f"[{card}] {name} predict() (b) ({N_SCENES} rows of {BUCKET} slots): peak device "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                  f"(max_memory_allocated; {held / 2**30:.3f} GiB held before the call)",
                  flush=True)
            walls = {
                f"test_{name}": (_host_times(
                    lambda: tr.test(eval_batch=EVAL_BATCH), card,
                    f"{name} test() ({n_peds} peds in {EVAL_BATCH}x{N_MAX} slots)", n_peds,
                    runs=GROUP_ZONE_RUNS), lambda: tr.test(eval_batch=EVAL_BATCH)),
                f"predict_{name}": (_host_times(
                    lambda: predictor.predict(*whole), card,
                    f"{name} predict() request (b) ({n_peds} peds in {N_SCENES}x{BUCKET} slots)",
                    n_peds, runs=GROUP_ZONE_RUNS), lambda: predictor.predict(*whole))}
            if profile_dir is not None:
                for label, (wall_s, fn) in walls.items():
                    _profile(label, fn, card, wall_s, profile_dir)
                _profile_train(card, name, tr, 1, profile_dir)
            t_part = _lap(card, name, "host-clock times and profiles", t_part)

            # --- 5. ET-GP-Graph-STGCNN: a resume against the straight fit(2) ---
            if name == "gpgraphstgcnn":
                straight = ETTorchTrainer(cfg, tag="smoke-straight", datasets=splits)
                straight.model.load_state_dict(tr.model.state_dict())
                first = ETTorchTrainer(cfg, tag="smoke-resume", datasets=splits)
                first.model.load_state_dict(tr.model.state_dict())
                for t in (straight, first):
                    t._set_et(tr.et)
                group.LAUNCHES = 0
                straight.fit(num_epochs=2, verbose=False)
                first.fit(num_epochs=1, checkpoint_every=1, verbose=False)
                resumed = ETTorchTrainer(cfg, tag="smoke-resume", datasets=splits)
                resumed.fit(num_epochs=2, resume=True, verbose=False)
                launches["group"] += group.LAUNCHES
                gaps = [abs(a - b) / abs(b) for a, b in zip(resumed.log["train_loss"],
                                                            straight.log["train_loss"])]
                # Not bitwise on the card: its reductions (cuDNN's weight
                # gradients) vary from run to run by ~1e-7, which the
                # inverse-distance adjacency amplifies (step 7 holds
                # ET-STGCNN's resume to 1e-3).
                if len(resumed.epoch_timer.durations) != 1 or len(gaps) != 2 or max(gaps) > 1e-4:
                    raise AssertionError(f"{name}: fit(1) + resume gave {resumed.log} against "
                                         f"the straight run's {straight.log}")
                print(f"[{card}] {name} fit(1) + resume.pt + fit(2) against fit(2): train losses "
                      f"{resumed.log['train_loss']} vs {straight.log['train_loss']}, relative "
                      f"gaps {[f'{g:.3e}' for g in gaps]} (<= 1e-4)", flush=True)
            print(f"[{card}] step 11 {name}: {time.perf_counter() - t_model:.1f} s", flush=True)

        # --- 6. ET-DMRGCN (eth weights) on the dense block: test() and a step ---
        name = "dmrgcn"
        cfg = load_config(os.path.join(REPO, "configs", f"eigentrajectory-{name}-eth.json"),
                          checkpoint_dir=ckpt_dir, n_max_peds=N_MAX)
        blob = torch.load(os.path.join(REPO, "benchmarks", "ref_resume", f"{name}-eth.pt"),
                          map_location="cpu", weights_only=False)["best_model"]
        pth = os.path.join(ckpt_dir, f"{name}-model_best.pth")
        with open(pth, "wb") as f:
            f.write(blob)
        tr = import_checkpoint_to_trainer(cfg, pth, "imported", datasets=dense_splits)
        tr_cpu = ETTorchTrainer(cfg, tag="imported", datasets=dense_splits, device="cpu")
        tr_cpu.load_model()
        with _band_edges_on_failure(name, lambda: tr_cpu.test(eval_batch=EVAL_BATCH)):
            _, n = _check_test(f"{name} (eth weights, dense block)", tr, tr_cpu, recon)
        launches["recon_metrics"] += n
        keeps = draw_edge_keeps(tr.model, torch.Generator().manual_seed(cfg.seed + 1),
                                TRAIN_BATCH, N_MAX)

        def probe():
            cpu = _copy_trainer(tr, "cpu", torch.float32)
            with torch.no_grad():
                cpu._chunk_loss(*cpu._to_device(dense_block))

        with _band_edges_on_failure(name, probe):
            _check_one_step(name, tr, dense_block, "dense block, eth weights, DropEdge on",
                            edge_keeps=keeps)

    # --- 7. the relabel kernel against its plain version, and its times ---
    before, errs = group.LAUNCHES, []
    for shape in ((EVAL_BATCH, N_MAX), (N_SCENES, BUCKET), (1, 2 * BUCKET)):
        if shape not in noted:
            raise AssertionError(f"group_relabel: no main-path call at {shape} was noted")
        merge, valid = noted[shape]
        label = {(1, 2 * BUCKET): "request (c), 150 pedestrians"}.get(shape, "main path")
        errs.append(_relabel_check(group, merge, valid, label))
    rng = np.random.default_rng(31)
    # Random masks, the kernel's tier edges (labels in registers up to 64,
    # 128, 256 slots, in shared memory past them) among them.
    for n, b in ((31, 3), (32, 3), (33, 3), (64, 3), (65, 3), (128, 3), (129, 3), (256, 3),
                 (257, 3), (1025, 2)):
        dist = torch.from_numpy(rng.random((b, n, n)).astype(np.float32))
        valid = torch.from_numpy(np.arange(n)[None] < rng.integers(n // 2, n + 1, size=(b, 1)))
        merge = gpgraph_common.merge_mask(dist, torch.tensor(min(0.3, 2.0 / n)), valid)
        errs.append(_relabel_check(group, merge.cuda(), valid.cuda(),
                                   f"random mask, density {float(merge.float().mean()):.4f}"))
    all_merge = {shape: _all_merge(gpgraph_common, *shape) for shape in ((4, N_MAX),
                                                                         (1, 2 * BUCKET))}
    for merge, valid in all_merge.values():
        errs.append(_relabel_check(group, merge, valid, "all-merge mask"))
    times = {shape: _relabel_times(group, card, *noted[shape], plain_iters=iters,
                                   label="request (c)" if shape[0] == 1 else "main path")
             for shape, iters in (((EVAL_BATCH, N_MAX), 5), ((N_SCENES, BUCKET), 2),
                                  ((1, 2 * BUCKET), 5))}
    times.update({("all-merge",) + shape: _relabel_times(group, card, *args, plain_iters=1,
                                                         label="all-merge")
                  for shape, args in all_merge.items()})
    group.LAUNCHES = before
    print(f"[{card}] step 11 (groups and zones) ran {time.perf_counter() - t_step:.1f} s",
          flush=True)
    return launches, max(errs), times


# Step 12: data parallelism. DP_WORLD ranks spawned on the card(s), each
# check held against the single-card run of the same call.
DP_WORLD, DP_TIMED_STEPS = 2, 10


def _dp_step(tr, batch, noted):
    """One step's loss, gradients and BN statistics on the whole `batch` (a
    rank's part of it), on the host, with the DropEdge masks used."""
    import torch

    tr.model.train()
    noted.clear()
    args, part = tr.step_args(batch)
    loss = tr.loss_and_grads(*args, part=part)
    tr.model.eval()
    host = lambda x: x.detach().to("cpu", copy=True)
    return {"loss": float(loss),
            "grads": {n: host(p.grad) for n, p in tr.model.named_parameters()
                      if p.grad is not None},
            "stats": {k: host(v) for k, v in tr.model.state_dict().items() if "running_" in k},
            # The masks of this process's rows (its chunks' one after another).
            "keeps": [host(torch.cat(rows)) for rows in zip(*noted)],
            "dropout_state": tr.dropout_generator.get_state()}


def _dp_agentformer(world, tr, noted):
    """Step 12's ET-AgentFormer case at `world` ranks (this process's rank):
    one step with dropout on, on the first packed batch (a rank's range of
    its slots), with the shapes of its six attention score tensors and the
    step's peak device memory; the `train.all_gather` spans of a profiled
    forward and backward (host ms each), its wall and its kernels' device
    time (the ranges' device-side twins left out); one
    gather of the encoder's keys alone, forward, then forward and backward
    (world > 1); the median of DP_TIMED_STEPS steps."""
    import itertools

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from eigentrajectory_tpu_torch import parallel
    from eigentrajectory_tpu_torch.data.batching import slot_width
    from eigentrajectory_tpu_torch.models.agentformer import TF_MODEL_DIM, AgentAwareAttention

    batches = list(itertools.islice(tr.train_batches(0), DP_TIMED_STEPS))
    scores = []
    hooks = [m.dropout.register_forward_hook(
        lambda mod, inp, o: scores.append(tuple(inp[0].shape)))
        for m in tr.model.modules() if isinstance(m, AgentAwareAttention)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        out = _dp_step(tr, batches[0], noted)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    out.update(scores=scores, slots=batches[0].obs.shape[0], held=held,
               peak=torch.cuda.max_memory_allocated())

    tr.model.train()
    args, part = tr.step_args(batches[0])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.loss_and_grads(*args, part=part)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # Host spans only: with CUDA activity each also has a device-side twin.
    out["spans"] = [e.cpu_time_total / 1e3 for e in prof.events()
                    if e.name == "train.all_gather" and e.device_type == DeviceType.CPU]
    out["profiled"] = (wall, sum(e.self_device_time_total for e in prof.key_averages()
                                 if e.device_type == DeviceType.CUDA
                                 and not e.is_user_annotation) / 1e3)
    if world > 1:
        m = slot_width(out["slots"], world)
        x = torch.randn(1, (tr.cfg.k + 2) * m, 3 * TF_MODEL_DIM, device=tr.device,
                        requires_grad=True)
        times = {"forward": [], "forward + backward": []}
        for _ in range(DP_TIMED_STEPS):
            for label, grad in (("forward", False), ("forward + backward", True)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.set_grad_enabled(grad):
                    y = parallel.all_gather_rows(x)
                    if grad:
                        y.sum().backward()
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t0) * 1e3)
        out["gather_ms"] = (tuple(x.shape), times)
    times = []
    for batch in batches:
        args, part = tr.step_args(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(*args, part=part)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    tr.model.eval()
    out["step_ms"] = times
    return out


def _dp_cases(world, tmp, th, split=1, agentformer=True):
    """Step 12's path at `world` ranks (this process's rank of them; world 1
    runs alone): steps of ET-STGCNN (hotel checkpoint, first and 21-scene
    last block), ET-PECNet (univ checkpoint, first packed batch), ET-DMRGCN
    (DropEdge on) and ET-GP-Graph-STGCNN (micro_batches 4, th given), the
    step time, test() of the 320 x 57 block, fit(2) and fit(1) + resume to
    2; with `agentformer`, ET-AgentFormer's case (`_dp_agentformer`, zara2
    checkpoint). `split` multiplies the sequenced configurations'
    micro_batches (at world 1, `split` = DP_WORLD runs each block in the
    chunks the ranks hold). Returns the results on the host and the kernel
    launches."""
    import torch
    from eigentrajectory_tpu_torch.config import load_config
    from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
    from eigentrajectory_tpu_torch.interop import params_from_jax, read_flax_msgpack
    from eigentrajectory_tpu_torch.ops import col, group, recon
    from eigentrajectory_tpu_torch.train import ETTorchTrainer
    from eigentrajectory_tpu_torch.train import trainer as trainer_module

    def cfg(model, dataset, **kw):
        c = load_config(os.path.join(REPO, "configs", f"eigentrajectory-{model}-{dataset}.json"),
                        **{"checkpoint_dir": CKPT_DIR, "n_max_peds": N_MAX,
                           "mesh_data_axis": world, **kw})
        return c.replace(micro_batches=c.micro_batches * split)

    noted, set_keeps = [], trainer_module.set_edge_keeps

    def noting(model, keeps):
        if keeps:
            noted.append(keeps)
        return set_keeps(model, keeps)

    trainer_module.set_edge_keeps = noting
    recon.LAUNCHES = recon.RECONSTRUCT_LAUNCHES = group.LAUNCHES = 0
    col_before = col.LAUNCHES           # not reset: world 1 runs in the main process
    out = {}
    try:
        seq = _sequenced_splits(make_synthetic_data(n_scenes=N_SCENES, max_peds=5, seed=0))
        st = ETTorchTrainer(cfg("stgcnn", "hotel"), tag="parity", datasets=seq)
        st.load_model()
        out["test"] = st.test(eval_batch=EVAL_BATCH)
        out["test_launches"] = recon.LAUNCHES
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.test(eval_batch=EVAL_BATCH)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out["test_s"] = _median(walls)
        blocks = list(st.train_batches(0))
        if int(blocks[-1].scene_valid.sum()) != TRAIN_SCENES % TRAIN_BATCH:
            raise AssertionError("the last block must hold the 21 real scenes")
        out["stgcnn_first"] = _dp_step(st, blocks[0], noted)
        out["stgcnn_last"] = _dp_step(st, blocks[-1], noted)

        pe = ETTorchTrainer(load_config(os.path.join(REPO, "configs",
                                                     "eigentrajectory-pecnet-univ.json"),
                                        checkpoint_dir=CKPT_DIR, mesh_data_axis=world),
                            tag="parity", datasets=_collated_splits())
        pe.load_model()
        out["pecnet"] = _dp_step(pe, next(iter(pe.train_batches(0))), noted)

        if agentformer:
            af = ETTorchTrainer(load_config(os.path.join(REPO, "configs", AGENTFORMER_CFG),
                                            checkpoint_dir=CKPT_DIR, mesh_data_axis=world),
                                tag="parity", datasets=_collated_splits())
            af.load_model()
            out["agentformer"] = _dp_agentformer(world, af, noted)
            del af

        dm = ETTorchTrainer(cfg("dmrgcn", "eth"), tag="dp", datasets=seq)
        dm._set_et(st.et)
        out["dmrgcn"] = _dp_step(dm, blocks[0], noted)

        gp = ETTorchTrainer(cfg("gpgraphstgcnn", "hotel"), tag="dp", datasets=seq)
        if gp.cfg.micro_batches != 4 * split:
            raise AssertionError("ET-GP-Graph-STGCNN's hotel configuration has micro_batches 4")
        gp._set_et(st.et)
        with torch.no_grad():
            gp.model.group_gen.th.fill_(th)
        out["gpgraph"] = _dp_step(gp, blocks[0], noted)

        # The step time: the epoch's first blocks, a synchronize at each end.
        st.model.train()
        times = []
        for batch in (blocks * 2)[:DP_TIMED_STEPS]:
            args, part = st.step_args(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.train_step(*args, part=part)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        st.model.eval()
        out["step_ms"] = times
        if world > 1:
            # The step's all-reduce alone: a buffer of its size, synchronized.
            from eigentrajectory_tpu_torch import parallel

            n = sum(p.numel() for p in st._called) + \
                sum(b.numel() for b in st.model.buffers()) + 2
            buf, times = torch.zeros(n, device=st.device), []
            for _ in range(DP_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                parallel.all_reduce_sum_(buf)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out["all_reduce"] = (n, times)

        hotel = params_from_jax(read_flax_msgpack(
            os.path.join(CKPT_DIR, "parity", "hotel", "model_best.msgpack")))
        logs = {}
        for tag, runs in (("fit", ((2, False, 0),)), ("resume", ((1, False, 1), (2, True, 0)))):
            for epochs, resume, every in runs:
                tr = ETTorchTrainer(cfg("stgcnn", "hotel", checkpoint_dir=tmp), tag=tag,
                                    datasets=seq)
                tr.load_state(*hotel)
                tr.fit(epochs, verbose=False, resume=resume, checkpoint_every=every)
            logs[tag] = dict(tr.log)
        out["fit"], out["resume"] = logs["fit"], logs["resume"]
    finally:
        trainer_module.set_edge_keeps = set_keeps
    out["launches"] = {"recon_metrics": recon.LAUNCHES,
                       "reconstruct": recon.RECONSTRUCT_LAUNCHES, "group": group.LAUNCHES,
                       "col": col.LAUNCHES - col_before}
    return out


def _dp_rank(rank, world, init, share_card, tmp, th):
    """A rank of step 12: joins the group (NCCL with a card of its own, or
    gloo on one shared card), runs `_dp_cases` and saves its results."""
    import torch
    from eigentrajectory_tpu_torch import parallel

    parallel.init_process_group(rank, world, init, device="cuda", share_card=share_card)
    try:
        torch.save(_dp_cases(world, tmp, th), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        parallel.destroy()


def _dp_threshold(th_trainer, block):
    """GP-Graph's th midway between two adjacent distinct pair distances of
    the block's valid pairs at their 0.3 quantile, with the gap between them."""
    import numpy as np
    import torch

    seen, distances = [], th_trainer.model.group_gen.distances
    th_trainer.model.group_gen.distances = \
        lambda v, valid: seen.append(distances(v, valid)) or seen[-1]
    try:
        with torch.no_grad():
            th_trainer._chunk_loss(*th_trainer._to_device(block))
    finally:
        del th_trainer.model.group_gen.distances
    dist, valid = seen[0].cpu().numpy(), block.ped_valid
    pairs = np.tril(np.ones(dist.shape[1:], bool), -1)[None] & valid[:, :, None] & valid[:, None]
    values = np.unique(dist[pairs])
    i = int(0.3 * (len(values) - 1))
    return float((values[i] + values[i + 1]) / 2), float(values[i + 1] - values[i])


def _step_distance(want, got):
    """(max abs, global relative L2) of the gradients (NaN entries left
    out), max of the BN statistics' differences over their scale (at least
    1, the checkpoints' variances reach the hundreds)."""
    import torch

    v1 = torch.cat([g.double().reshape(-1) for g in want["grads"].values()]).nan_to_num()
    v2 = torch.cat([got["grads"][n].double().reshape(-1) for n in want["grads"]]).nan_to_num()
    stats = max([float((got["stats"][k] - v).abs().max() / max(1.0, float(v.abs().max())))
                 for k, v in want["stats"].items()] or [0.0])
    return float((v1 - v2).abs().max()), float((v1 - v2).norm() / v1.norm()), stats


def _dp_close(label, want, got, unsplit=None, rtol=2e-3, atol=1e-5):
    """Max abs error of a step (loss, gradients, BN statistics, masks) of
    `got` against `want`: gradients within 5e-5 global relative L2 and every
    entry within rtol / atol (NaN where NaN), loss within 1e-5 relative, BN
    statistics within 1e-6 of their scale (at least 1), DropEdge masks and
    the dropout generator's state bitwise. Where `want` ran the block in the
    ranks' chunks, prints the distances of both from the `unsplit` run."""
    import torch

    if abs(got["loss"] - want["loss"]) > 1e-5 * abs(want["loss"]):
        raise AssertionError(f"{label}: loss {got['loss']} vs {want['loss']}")
    if set(got["grads"]) != set(want["grads"]):
        raise AssertionError(f"{label}: other parameters got gradients")
    _, rel, stats = _step_distance(want, got)
    err = 0.0
    for name, g in want["grads"].items():
        h = got["grads"][name]
        if not torch.equal(torch.isnan(g), torch.isnan(h)):
            raise AssertionError(f"{label}: {name} NaN at other entries")
        ok = ~torch.isnan(g)
        d = (h[ok] - g[ok]).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
        if (d > atol + rtol * g[ok].abs()).any():
            raise AssertionError(f"{label}: gradient {name} off by {float(d.max()):.3e}")
    if rel >= 5e-5 or stats > 1e-6:
        raise AssertionError(f"{label}: gradient rel-L2 {rel:.3e}, BN statistics {stats:.3e}")
    if len(got["keeps"]) != len(want["keeps"]) or not all(
            torch.equal(a, b) for a, b in zip(got["keeps"], want["keeps"])) or \
            not torch.equal(got["dropout_state"], want["dropout_state"]):
        raise AssertionError(f"{label}: DropEdge masks or the dropout stream differ")
    print(f"  {label}: loss {got['loss']:.6f} (world 1 {want['loss']:.6f}); gradients max abs "
          f"err {err:.3e}, rel-L2 {rel:.3e}; BN statistics {stats:.3e} of scale"
          + (f"; DropEdge masks bitwise ({len(want['keeps'])} layers)" if want["keeps"] else ""),
          flush=True)
    if unsplit is not None:
        print("    from world 1 in one piece (max abs, rel-L2, BN): world %d %.3e, %.3e, %.3e; "
              "world 1 in the ranks' chunks %.3e, %.3e, %.3e" % (
                  DP_WORLD, *_step_distance(unsplit, got), *_step_distance(unsplit, want)),
              flush=True)
    return err


def _dp_agentformer_report(card, want, ranks):
    """Checks and prints step 12's ET-AgentFormer split: each rank's six
    attentions score T * ceil(P / DP_WORLD) query rows against all T * P
    keys (fewer rows than world 1's, the rows inside the row adding up to
    world 1's); 13 `train.all_gather` spans a step on every rank (7 gathers
    forward: the inputs' once, then each attention's keys; 6 all-reduces
    backward), none at world 1; then the peak memory, the gather alone and
    the step times."""
    from eigentrajectory_tpu_torch.data.batching import slot_width

    p = want["slots"]
    m = slot_width(p, DP_WORLD)
    if len(want["scores"]) != 6:
        raise AssertionError(f"ET-AgentFormer: {len(want['scores'])} attentions, expected 6")
    in_row = [0] * 6
    for rank, res in enumerate(ranks):
        for i, (mine, whole) in enumerate(zip(res["scores"], want["scores"])):
            t_len = whole[2] // p
            if mine[2] != t_len * m or mine[2] >= whole[2] or mine[3] != whole[3] or \
                    mine[:2] != whole[:2]:
                raise AssertionError(f"ET-AgentFormer rank {rank} attention {i}: scores "
                                     f"{mine}, world 1 {whole}")
            in_row[i] += t_len * min(m, max(0, p - rank * m))
    if in_row != [s[2] for s in want["scores"]]:
        raise AssertionError(f"ET-AgentFormer: the ranks' query rows {in_row} are not world 1's")
    if want["spans"] or any(len(r["spans"]) != 13 for r in ranks):
        raise AssertionError(f"ET-AgentFormer train.all_gather spans: world 1 "
                             f"{len(want['spans'])}, ranks {[len(r['spans']) for r in ranks]}")
    gib = 2 ** 30
    print(f"  ET-AgentFormer attention rows (query x key tokens of the six score tensors, "
          f"P = {p} slots, {m} a rank): world 1 {[s[2:] for s in want['scores']]}; "
          + "; ".join(f"rank {r} {[s[2:] for s in res['scores']]}" for r, res in enumerate(ranks)),
          flush=True)
    print(f"[{card}] step 12 ET-AgentFormer, world {DP_WORLD}: step peak device memory "
          + ", ".join(f"rank {r} {res['peak'] / gib:.3f} GiB ({res['held'] / gib:.3f} held "
                      f"before)" for r, res in enumerate(ranks))
          + f"; world 1 {want['peak'] / gib:.3f} GiB ({want['held'] / gib:.3f} held before) "
          f"(max_memory_allocated); train.all_gather spans a step {len(ranks[0]['spans'])} "
          f"(rank 0 host ms {[round(x, 3) for x in ranks[0]['spans']]}, sum "
          f"{sum(ranks[0]['spans']):.3f}); profiled forward + backward wall / device ms: "
          + ", ".join(f"rank {r} {res['profiled'][0]:.3f} / {res['profiled'][1]:.3f}"
                      for r, res in enumerate(ranks))
          + f", world 1 {want['profiled'][0]:.3f} / {want['profiled'][1]:.3f}; one gather of "
          f"{ranks[0]['gather_ms'][0]} alone, median "
          + ", ".join(f"{label} {_median(t):.3f} ms"
                      for label, t in ranks[0]["gather_ms"][1].items())
          + f"; step median "
          f"{_median(ranks[0]['step_ms']):.3f} ms (world 1 {_median(want['step_ms']):.3f} ms; "
          f"host clock, synchronized, {DP_TIMED_STEPS} steps)", flush=True)


def _data_parallel_phase(card, recon, seq_data):
    """Step 12: DP_WORLD ranks against the single card, and the predictor
    over a mesh. Returns the kernels' launches of the sharded path (every
    rank's) and of the mesh predictor."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from eigentrajectory_tpu_torch import parallel
    from eigentrajectory_tpu_torch.config import load_config
    from eigentrajectory_tpu_torch.inference import ETPredictor
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    share = cards < DP_WORLD
    print(f"step 12: {DP_WORLD} ranks, " + (
        f"both on cuda:0 with gloo ({cards} card visible): collectives go through the host, "
        f"every kernel and model op runs on the card" if share else
        f"NCCL, a card each of {cards}"), flush=True)
    splits = _sequenced_splits(seq_data)
    gp_cfg = load_config(
        os.path.join(REPO, "configs", "eigentrajectory-gpgraphstgcnn-hotel.json"),
        checkpoint_dir=CKPT_DIR, n_max_peds=N_MAX)
    st = ETTorchTrainer(load_config(os.path.join(REPO, "configs",
                                                 "eigentrajectory-stgcnn-hotel.json"),
                                    checkpoint_dir=CKPT_DIR, n_max_peds=N_MAX),
                        tag="parity", datasets=splits)
    st.load_model()
    gp = ETTorchTrainer(gp_cfg, tag="dp", datasets=splits)
    gp._set_et(st.et)
    th, gap = _dp_threshold(gp, next(iter(gp.train_batches(0))))
    print(f"  GP-Graph th {th:.6g} midway in a gap of {gap:.3e} between pair distances",
          flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "w1"))
        t0 = time.perf_counter()
        # The sequenced steps are held to world 1 running each block in the
        # chunks the ranks hold (micro_batches x DP_WORLD): the same
        # arithmetic, so what is left is what the sharding adds. On the card
        # the chunks' cuDNN calls round otherwise than one call over the
        # block; the distance of both from the block in one piece is printed.
        want = _dp_cases(1, os.path.join(tmp, "w1"), th, split=DP_WORLD)
        t1 = time.perf_counter() - t0
        os.makedirs(os.path.join(tmp, "whole"))
        whole_block = _dp_cases(1, os.path.join(tmp, "whole"), th, agentformer=False)
        t0 = time.perf_counter()
        init = f"file://{os.path.join(tmp, 'init')}"
        mp.spawn(_dp_rank, args=(DP_WORLD, init, share, tmp, th), nprocs=DP_WORLD)
        tn = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
    got = ranks[0]
    print(f"  world 1 ran {t1:.1f} s in this process; world {DP_WORLD} {tn:.1f} s, the ranks' "
          f"start included", flush=True)

    errs = {}
    for key, label in (("stgcnn_first", "ET-STGCNN step, first 128 x 57 block"),
                       ("stgcnn_last", "ET-STGCNN step, last block (21 real scenes)"),
                       ("pecnet", "ET-PECNet step, first packed batch (scenes split)"),
                       ("agentformer", "ET-AgentFormer step, first packed batch (slots split, "
                                       "attention across the ranks), dropout on"),
                       ("dmrgcn", "ET-DMRGCN step, DropEdge on"),
                       ("gpgraph", "ET-GP-Graph-STGCNN step, micro_batches 4")):
        # The ranks' DropEdge masks, row after row, are the whole block's.
        keeps = [torch.cat(rows) for rows in zip(*(r[key]["keeps"] for r in ranks))]
        errs[key] = _dp_close(label, want[key], {**got[key], "keeps": keeps},
                              unsplit=None if key in ("pecnet", "agentformer") else
                              whole_block[key])
        for other in ranks[1:]:      # the all-reduce leaves every rank the same step
            if other[key]["loss"] != got[key]["loss"] or not all(
                    torch.allclose(other[key]["grads"][n], g, rtol=0, atol=0, equal_nan=True)
                    for n, g in got[key]["grads"].items()):
                raise AssertionError(f"{key}: the ranks hold different steps")
    _dp_agentformer_report(card, want["agentformer"], [r["agentformer"] for r in ranks])
    test_err = max(abs(got["test"][k] - v) for k, v in want["test"].items())
    if any(abs(got["test"][k] - v) > 1e-6 + 1e-5 * abs(v) for k, v in want["test"].items()):
        raise AssertionError(f"test(): world {DP_WORLD} {got['test']} vs world 1 {want['test']}")
    launches = [r["test_launches"] for r in ranks]
    if want["test_launches"] != 1 or launches != [1] * DP_WORLD:
        raise AssertionError(f"test(): fused_recon_metrics launches {want['test_launches']} / "
                             f"{launches}, expected 1 a rank")
    fit_err = float(np.max(np.abs(np.subtract(got["fit"]["train_loss"],
                                              want["fit"]["train_loss"])) /
                           np.abs(want["fit"]["train_loss"])))
    if fit_err > 2e-3 or not all(math.isfinite(v) for v in got["fit"]["val_loss"]):
        raise AssertionError(f"fit(2): world {DP_WORLD} {got['fit']} vs world 1 {want['fit']}")
    resume_err = float(np.max(np.abs(np.subtract(got["resume"]["train_loss"],
                                                 got["fit"]["train_loss"])) /
                              np.abs(got["fit"]["train_loss"])))
    # Not bitwise on the card (cuDNN's weight gradients add in no fixed
    # order, and ET-STGCNN's 1/d adjacency amplifies it): 1e-5 relative.
    if resume_err > 1e-5:
        raise AssertionError(f"fit(1) + resume: {got['resume']} vs fit(2) {got['fit']}")
    print(f"  test() of the {EVAL_BATCH} x {N_MAX} block: max abs err {test_err:.3e} over "
          f"{sorted(want['test'])}, fused_recon_metrics once a rank ({launches}); "
          f"fit(2) train losses {got['fit']['train_loss']} within {fit_err:.3e} relative of "
          f"world 1; fit(1) + resume within {resume_err:.3e} of fit(2)", flush=True)
    print(f"[{card}] step 12 world {DP_WORLD} ({'gloo' if share else 'nccl'}): ET-STGCNN step "
          f"median {_median(got['step_ms']):.3f} ms (host clock, synchronized, "
          f"{DP_TIMED_STEPS} steps; world 1 {_median(whole_block['step_ms']):.3f} ms); test() "
          f"median of 5 {got['test_s'] * 1e3:.3f} ms (world 1 "
          f"{whole_block['test_s'] * 1e3:.3f} ms); the step's all-reduce alone "
          f"({got['all_reduce'][0]} floats) {_median(got['all_reduce'][1]):.3f} ms", flush=True)

    # predict() request (b) over a mesh of every visible card, and of cuda:0 twice.
    counts = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    whole = (seq_data.obs_traj, np.repeat(np.arange(N_SCENES), seq_data.num_peds_in_seq))
    ref = ETPredictor(st, bucket=BUCKET).predict(*whole)
    for mesh in (parallel.make_mesh(), parallel.make_mesh(devices=["cuda:0", "cuda:0"])):
        predictor = ETPredictor(st, bucket=BUCKET, mesh=mesh)
        recon.RECONSTRUCT_LAUNCHES = 0
        out = predictor.predict(*whole)
        n = recon.RECONSTRUCT_LAUNCHES
        err = float(np.abs(out - ref).max())
        if n != len(mesh) or out.shape != ref.shape or err > 1e-5:
            raise AssertionError(f"predict() over {mesh}: {n} launches, err {err:.3e}")
        counts["reconstruct"] += n
        errs[f"predict {len(mesh)}"] = err
        print(f"  predict() (b) over {[str(d) for d in mesh]}: max abs err {err:.3e} against "
              f"mesh=None, fused_reconstruct {n} launches", flush=True)
    # The NCCL branch of the process-group helpers (what ranks with a card
    # each take), in a group of one on cuda:0.
    with tempfile.TemporaryDirectory() as tmp:
        group = parallel.init_process_group(0, 1, f"file://{os.path.join(tmp, 'init')}",
                                            device="cuda")
        try:
            buf = torch.arange(5.0, device="cuda")
            parallel.all_reduce_sum_(buf)
            parallel.barrier()
            if group.backend != "nccl" or not torch.equal(buf.cpu(), torch.arange(5.0)) or \
                    parallel.broadcast_object({"x": 1}) != {"x": 1}:
                raise AssertionError(f"NCCL group of one: {group}, {buf}")
            # The gather's NCCL route (on the card, no host copy), forward and backward.
            x = torch.randn(1, 3 * 5, 4, device="cuda", requires_grad=True)
            w = torch.randn(1, 1, 3 * 5, 4, device="cuda")
            stacked = parallel.all_gather_rows(x)
            (stacked * w).sum().backward()
            row = parallel.SlotShard(0, 1, 5).gather(x)
            if stacked.device != x.device or not torch.equal(stacked, x[None]) or \
                    not torch.equal(x.grad, w[0]) or not torch.equal(row, x):
                raise AssertionError("NCCL group of one: all_gather_rows is not the identity")
        finally:
            parallel.destroy()
    print(f"  NCCL group of one on {group.device}: all-reduce, broadcast, barrier and "
          f"all_gather_rows (forward and backward, the identity at world 1) ran", flush=True)
    print(f"[{card}] step 12 ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


# --------------------------------------------------------------------------
# Step 13: the native loader on the main path, the dormant modules, the
# descriptor evaluation and the loss log of load_model()
# --------------------------------------------------------------------------

def _write_split(directory, rng):
    """One split file in the ETH-UCY text format (`frame ped x y`, tab
    separated, sorted, frames numbered in tens) over 360 frames: each of 150
    pedestrians walks for 20-34 consecutive frames starting anywhere in the
    file, a straight line plus the random-walk wiggle of
    `make_synthetic_data`. That makes about 300 scenes of about 1,150
    pedestrians, the size of hotel's test split."""
    import numpy as np

    rows = []
    for ped in range(150):
        length = int(rng.integers(20, 35))
        t0 = int(rng.integers(0, 360 - length + 1))
        start, vel = rng.normal(size=2) * 5, rng.normal(size=2)
        path = start + vel * 0.4 * np.arange(length)[:, None] + \
            0.05 * np.cumsum(rng.normal(size=(length, 2)), axis=0)
        rows += [((t0 + i) * 10, ped + 1, x, y) for i, (x, y) in enumerate(path)]
    rows.sort()
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "synthetic.txt"), "w") as f:
        f.write("".join("\t".join(str(v) for v in r) + "\n" for r in rows))


def _same_data(a, b):
    import numpy as np

    return a.seq_start_end == b.seq_start_end and all(
        getattr(a, k).dtype == getattr(b, k).dtype and
        np.array_equal(getattr(a, k), getattr(b, k))
        for k in ("obs_traj", "pred_traj", "non_linear_ped", "loss_mask", "num_peds_in_seq"))


def _scaled_err(got, want):
    """max |got - want| over max(max |want|, 1e-6), both moved to the CPU."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-6)


def _hold(errors, label, err, tol):
    errors[label] = err
    if not err <= tol:
        raise AssertionError(f"step 13 {label}: {err:.3g} over the tolerance {tol:g}")


def _native_main_path(card, recon, ds_root, errors):
    """(a): split files through the native loader and the Python loader,
    bitwise; ET-STGCNN's trainer (hotel checkpoint) from the files, its
    test() on the card against the CPU and against the same windows handed
    in memory. Returns the launches of fused_recon_metrics."""
    import torch
    from eigentrajectory_tpu_torch.config import load_config
    from eigentrajectory_tpu_torch.data import native_loader
    from eigentrajectory_tpu_torch.data.dataset import load_trajectory_data
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    test_dir = os.path.join(ds_root, "hotel", "test")
    t0 = time.perf_counter()
    lib = native_loader._load_lib()._name     # g++ at first use
    t_build = time.perf_counter() - t0
    walls = {True: [], False: []}          # use_native -> seconds, in turns
    for _ in range(10):
        for use_native in walls:
            t0 = time.perf_counter()
            data = load_trajectory_data(test_dir, use_native=use_native)
            walls[use_native].append(time.perf_counter() - t0)
            if use_native:
                native = data
            elif not _same_data(native, data):
                raise AssertionError("step 13: the native loader is not bitwise the Python "
                                     "loader")
    if os.path.dirname(lib) != os.path.join(REPO, "eigentrajectory_tpu_torch", "_build"):
        raise AssertionError(f"step 13: the native library was loaded from {lib}")
    t_native, t_python = _median(walls[True]), _median(walls[False])
    print(f"[{card}] step 13 (a) load of a test split of {native.num_scenes} scenes, "
          f"{native.num_peds} pedestrians (host clock, 10 loads a route in turns): native "
          f"median {t_native * 1e3:.3f} ms (first {walls[True][0] * 1e3:.3f}), Python median "
          f"{t_python * 1e3:.3f} ms (first {walls[False][0] * 1e3:.3f}), "
          f"{t_python / t_native:.2f}x; bitwise equal; library {os.path.relpath(lib, REPO)} "
          f"built and loaded in {t_build:.3f} s", flush=True)

    calls = []
    load_native = native_loader.load_trajectory_data_native

    def noting(data_dir, *args):
        calls.append(os.path.basename(data_dir))
        return load_native(data_dir, *args)

    cfg = load_config(os.path.join(REPO, "configs", "eigentrajectory-stgcnn-hotel.json"),
                      checkpoint_dir=CKPT_DIR, dataset_dir=ds_root, n_max_peds=N_MAX)
    native_loader.load_trajectory_data_native = noting
    try:
        t0 = time.perf_counter()
        tr = ETTorchTrainer(cfg, tag="parity")
        t_init = time.perf_counter() - t0
        tr_cpu = ETTorchTrainer(cfg, tag="parity", device="cpu")
    finally:
        native_loader.load_trajectory_data_native = load_native
    if calls != ["train", "val", "test"] * 2:
        raise AssertionError(f"step 13: the trainers loaded {calls} natively")
    tr.load_model()
    tr_cpu.load_model()
    blocks = -(-tr.data_test.num_scenes // EVAL_BATCH)
    n_peds = tr.data_test.num_peds
    recon.LAUNCHES = recon.RECONSTRUCT_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tr.test(eval_batch=EVAL_BATCH)
    torch.cuda.synchronize()
    t_test = time.perf_counter() - t0
    launches = recon.LAUNCHES
    if launches != blocks:
        raise AssertionError(f"step 13: test() from files launched fused_recon_metrics "
                             f"{launches} times for {blocks} block(s)")
    if not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"step 13: non-finite metrics {res}")
    res_cpu = tr_cpu.test(eval_batch=EVAL_BATCH)
    in_memory = ETTorchTrainer(cfg, tag="parity",
                               datasets=(tr.data_train, tr.data_val, tr.data_test))
    in_memory.load_model()
    before = recon.LAUNCHES
    res_mem = in_memory.test(eval_batch=EVAL_BATCH)
    launches_mem = recon.LAUNCHES - before
    if launches_mem != blocks:
        raise AssertionError(f"step 13: test() in memory launched {launches_mem} times")
    _hold(errors, "(a) test() from files, card vs CPU",
          max(abs(res[k] - v) / max(abs(v), 1.0) for k, v in res_cpu.items()), 1e-4)
    _hold(errors, "(a) test() from files vs in memory",
          max(abs(res[k] - v) / max(abs(v), 1.0) for k, v in res_mem.items()), 1e-4)
    print(f"[{card}] step 13 (a) ET-STGCNN (hotel checkpoint) from split files: trainer "
          f"with its three native loads {t_init:.3f} s, first test() {t_test * 1e3:.3f} ms "
          f"(host clock, synchronized) over {tr.data_test.num_scenes} scenes ({n_peds} "
          f"pedestrians) in {blocks} block(s) of {EVAL_BATCH}x{N_MAX}: {res}, "
          f"fused_recon_metrics launches={launches}; CPU {res_cpu}; in memory {res_mem} "
          f"({launches_mem} launches)", flush=True)
    _host_times(lambda: tr.test(eval_batch=EVAL_BATCH), card,
                f"step 13 (a) test() of the split loaded from files ({n_peds} peds)", n_peds,
                runs=10)
    return launches + launches_mem


def _dormant_modules(card, errors):
    """(b): the dormant modules card vs CPU in float32 from the port's
    seeded init, every draw injected or from a seeded generator."""
    import copy

    import numpy as np
    import torch
    from eigentrajectory_tpu_torch import metrics as M
    from eigentrajectory_tpu_torch.etspace import anchor
    from eigentrajectory_tpu_torch.models import graphtern, implicit, lbebm, pecnet

    rng = np.random.default_rng(13)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    def pair(module, prepare=lambda m: None):
        torch.manual_seed(13)
        cpu = module().eval()
        prepare(cpu)
        return cpu, copy.deepcopy(cpu).cuda()

    def both(fn, *args, **kw):
        cuda = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
        kw_cuda = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
        return fn[0](*args, **kw), fn[1](*cuda, **kw_cuda)

    n = TRAIN_BATCH                           # a packed batch of 128 pedestrians
    with torch.no_grad():
        # PECNet CVAE, both branches
        cpu, gpu = pair(lambda: pecnet.PECNetCVAE(K, K * S // 2 + 1))
        past, ip, dest, eps = arr(n, K), arr(n, 2), arr(n, 2), arr(n, pecnet.ZDIM)
        mask = torch.from_numpy(np.kron(np.eye(16, dtype=bool), np.ones((8, 8), bool)))
        want, got = both((cpu, gpu), past, ip, eps=eps, train=False)
        _hold(errors, "(b) PECNetCVAE eval", _scaled_err(got, want), 1e-4)
        want, got = both((cpu, gpu), past, ip, mask, dest, eps=eps, train=True)
        _hold(errors, "(b) PECNetCVAE train", max(_scaled_err(g, w) for g, w in zip(got, want)),
              1e-4)

        # LB-EBM CVAE, train branch without Langevin noise; the sampler alone
        cpu, gpu = pair(lambda: lbebm.LBEBMCVAE(K, K * S // 2))
        z0 = arr(n, lbebm.ZDIM, scale=lbebm.E_INIT_SIG)
        eps = arr(n, lbebm.ZDIM)
        want, got = both((cpu, gpu), past, dest, z_e_0=z0, eps=eps, train=True,
                         langevin_noise=False)
        _hold(errors, "(b) LBEBMCVAE train 7-tuple",
              max(_scaled_err(g, w) for g, w in zip(got, want)), 1e-4)
        cond = arr(n, lbebm.FDIM)
        want, got = both((cpu.sample_langevin_prior_z, gpu.sample_langevin_prior_z), z0, cond,
                         with_noise=False)
        _hold(errors, "(b) Langevin sampler", _scaled_err(got, want), 1e-4)
        z0_card, cond_card = z0.cuda(), cond.cuda()
        gen = torch.Generator(device="cuda").manual_seed(0)

        def langevin():
            return gpu.sample_langevin_prior_z(z0_card, cond_card, generator=gen)

        langevin()                            # warm-up
        ms = sorted(_sync_ms(langevin)[2] for _ in range(7))
        print(f"[{card}] step 13 (b) Langevin prior sampler, {lbebm.E_L_STEPS} steps at "
              f"N = {n}, noise on: median {ms[3]:.3f} ms, min {ms[0]:.3f} ms, max "
              f"{ms[-1]:.3f} ms (CUDA events over 7 runs after a warm-up)", flush=True)

        # The full Social-Implicit
        def draw_scalars(model):              # the init's 0 would zero both streams
            gen = torch.Generator().manual_seed(5)
            for name, p in model.named_parameters():
                if name.endswith(("global_w", "local_w", "noise_w")):
                    p.copy_(0.5 + torch.rand(p.shape, generator=gen))

        cpu, gpu = pair(implicit.SocialImplicit, draw_scalars)
        v = arr(1, 2, 8, N_MAX)
        v[0, :, 0] = torch.from_numpy(rng.choice([0.005, 0.05, 0.5, 2.0], size=(2, N_MAX))
                                      .astype(np.float32))
        valid = torch.arange(N_MAX) < 50
        want, got = both((cpu, gpu), v, valid, noise=arr(S, 2))
        _hold(errors, "(b) SocialImplicit", _scaled_err(got, want), 1e-4)

        # Graph-TERN: the full model with an injected endpoint set
        cpu, gpu = pair(lambda: graphtern.GraphTERNFull(n_smpl=S))
        obs = arr(1, 8, N_MAX, 2, scale=3.0)
        rel = torch.cat([torch.zeros_like(obs[:, :1]), obs[:, 1:] - obs[:, :-1]], dim=1)
        s_obs = torch.stack([obs, rel], dim=1)
        want, got = both((cpu, gpu), s_obs, valid, endpoint_set=arr(S, N_MAX, 2))
        _hold(errors, "(b) GraphTERNFull", max(_scaled_err(g, w) for g, w in zip(got, want)),
              1e-4)
        v_init, v_pred, v_refi = gpu(s_obs.cuda(), valid.cuda(), pruning=2,
                                     generator=torch.Generator(device="cuda").manual_seed(1))
        redraw = torch.Generator(device="cuda").manual_seed(1)
        rounds = torch.stack([graphtern.gmm_endpoint_sample(v_init, S, 3, prune=2,
                                                            generator=redraw)
                              for _ in range(S)])
        if tuple(v_refi.shape) != (S, T, N_MAX, 2) or not torch.isfinite(v_refi).all() or \
                not torch.equal(v_pred[:, 0], graphtern.prune_select(rounds)) or \
                not all(any(torch.equal(v_pred[:, 0, p], rounds[r, :, p]) for r in range(S))
                        for p in range(N_MAX)):
            raise AssertionError("step 13: GraphTERNFull's pruning did not select drawn rounds")

        # GMM sampling at a near-zero std with one-hot pi: the chosen means
        m, ways = 8, 3
        heads = arr(1, m, N_MAX, 5 * ways)
        chosen = []
        for w in range(ways):
            heads[..., 5 * w + 2:5 * w + 4] = -20.0
            top = torch.from_numpy(rng.integers(0, m, size=N_MAX))
            logits = torch.full((m, N_MAX), -30.0)
            logits[top, torch.arange(N_MAX)] = 30.0
            heads[0, :, :, 5 * w + 4] = logits
            chosen.append(heads[0, top, torch.arange(N_MAX), 5 * w:5 * w + 2])
        got = graphtern.gmm_endpoint_sample(heads.cuda(), S, ways,
                                            generator=torch.Generator(device="cuda").manual_seed(2))
        _hold(errors, "(b) gmm_endpoint_sample collapse",
              _scaled_err(got, torch.stack(chosen).mean(0).expand(S, -1, -1)), 1e-5)

    # batch k-means: B = 8 problems, card vs CPU by inertia
    x = arr(8, 512, K)
    x += torch.from_numpy(rng.normal(size=(8, 1, K)).astype(np.float32)) * 4
    centers = {dev: anchor.batch_kmeans_fit(torch.Generator().manual_seed(3), x.to(dev), S)
               .cpu() for dev in ("cpu", "cuda")}
    inertia = {dev: ((x[:, :, None] - c[:, None]) ** 2).sum(-1).amin(-1).sum(-1)
               for dev, c in centers.items()}
    _hold(errors, "(b) batch_kmeans_fit inertia",
          float(((inertia["cuda"] - inertia["cpu"]).abs() / inertia["cpu"]).max()), 0.01)

    # compute_all and col_scene_masked: walkers 10 apart and two close pairs
    pred = arr(S, N_MAX, T, 2, scale=0.3) + 10.0 * torch.arange(N_MAX)[:, None, None]
    pred[:, 1] = pred[:, 0] + 0.05
    pred[:5, 3] = pred[:5, 4] + 0.1
    # GT beside each walker, so that the FDEs are O(1) and no two samples
    # come within rounding of a tie
    gt = arr(N_MAX, T, 2, scale=0.3) + 10.0 * torch.arange(N_MAX)[:, None, None]
    valid = torch.arange(N_MAX) < 50
    scene = torch.arange(N_MAX) // 3
    same = scene[:, None] == scene[None, :]
    want, got = both((M.compute_all, M.compute_all), pred, gt, valid)
    _hold(errors, "(b) compute_all ADE/FDE/TCC",
          max(_scaled_err(g, w) for g, w in zip(got[:3], want[:3])), 1e-5)
    got_sm = M.col_scene_masked(pred.cuda(), valid.cuda(), same.cuda()).cpu()
    want_sm = M.col_scene_masked(pred, valid, same)
    if not (torch.equal(got[3].cpu(), want[3]) and torch.equal(got_sm, want_sm)):
        raise AssertionError("step 13: COL card vs CPU not equal")
    if want[3][:2].tolist() != [100.0, 100.0] or want_sm[3] != 25.0 or want_sm[4] != 25.0:
        raise AssertionError(f"step 13: COL {want[3][:5]}, scene-masked {want_sm[:5]}")
    errors["(b) COL, scene-masked COL (exact)"] = 0.0


def _descriptor_eval(card, ds_root, errors):
    """(c): descriptor_evaluation.eval_dataset on the split files, card vs
    CPU."""
    import torch
    from eigentrajectory_tpu_torch.analysis import descriptor_evaluation

    t0 = time.perf_counter()
    rows = descriptor_evaluation.eval_dataset(os.path.join(ds_root, "hotel"), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows_cpu = descriptor_evaluation.eval_dataset(os.path.join(ds_root, "hotel"), device="cpu")
    _hold(errors, "(c) descriptor_evaluation", max(
        abs(r[k] - c[k]) for r, c in zip(rows, rows_cpu) for k in ("obs_error", "pred_error")),
        1e-5)
    svd6 = next(r for r in rows if r["method"] == "svd" and r["k"] == 6)
    print(f"[{card}] step 13 (c) descriptor_evaluation.eval_dataset: {len(rows)} descriptors "
          f"in {wall:.3f} s on the card; SVD k=6 obs {svd6['obs_error']:.6f} pred "
          f"{svd6['pred_error']:.6f}", flush=True)


def _log_restored(card, ds_root):
    """(d): a trainer fits 2 epochs; a fresh one's load_model() restores
    the loss log written beside the checkpoint."""
    from eigentrajectory_tpu_torch.config import load_config
    from eigentrajectory_tpu_torch.train import ETTorchTrainer
    from eigentrajectory_tpu_torch.train.trainer import read_log

    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = load_config(os.path.join(REPO, "configs", "eigentrajectory-stgcnn-hotel.json"),
                          checkpoint_dir=ckpt_dir, dataset_dir=ds_root, n_max_peds=N_MAX)
        tr = ETTorchTrainer(cfg, tag="smoke")
        tr.init_descriptor()
        tr.fit(num_epochs=2, verbose=False)
        with open(os.path.join(tr.checkpoint_dir, "log.pkl"), "rb") as f:
            written = read_log(f)
        best = min(range(2), key=lambda e: tr.log["val_loss"][e])
        fresh = ETTorchTrainer(cfg, tag="smoke", datasets=(tr.data_train, tr.data_val,
                                                            tr.data_test))
        fresh.load_model()
        if fresh.log != written or written != {k: v[:best + 1] for k, v in tr.log.items()}:
            raise AssertionError(f"step 13: load_model() log {fresh.log} vs the file's "
                                 f"{written} (the run's {tr.log})")
    print(f"[{card}] step 13 (d) load_model() restored the loss log: {fresh.log}", flush=True)


def _native_dormant_phase(card, recon):
    """Step 13. Returns the launches of fused_recon_metrics."""
    import numpy as np

    t_step = time.perf_counter()
    errors = {}
    with tempfile.TemporaryDirectory() as ds_root:
        rng = np.random.default_rng(2013)
        for split in ("train", "val", "test"):
            _write_split(os.path.join(ds_root, "hotel", split), rng)
        launches = _native_main_path(card, recon, ds_root, errors)
        _dormant_modules(card, errors)
        _descriptor_eval(card, ds_root, errors)
        _log_restored(card, ds_root)
    for label, err in errors.items():
        print(f"[{card}] step 13 {label}: largest error {err:.3g}", flush=True)
    print(f"[{card}] step 13 (native loader, dormant modules, analysis, loss log) ran "
          f"{time.perf_counter() - t_step:.1f} s", flush=True)
    return launches


def main(argv):
    import torch

    profile_dir = ab_dir = None
    if argv[:1] == ["--profile"] and len(argv) == 2:
        profile_dir = argv[1]
    elif argv[:1] == ["--ab"] and len(argv) == 2:
        ab_dir = os.path.abspath(argv[1])
    elif argv:
        raise SystemExit("usage: python3 chip_smoke.py [--profile OUT_DIR | --ab OLD_CSRC_DIR]")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs only on the card")
    t_start = time.perf_counter()

    import numpy as np
    from eigentrajectory_tpu_torch.config import load_config
    from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
    from eigentrajectory_tpu_torch.ops import attention, build, col, group, recon
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)

    # --- 1. build: one nvcc for each source, started together ---
    sources = (recon.SOURCE, recon.RECONSTRUCT_SOURCE, group.SOURCE, col.SOURCE,
               attention.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(build.build, sources))
    print(f"built {', '.join(os.path.relpath(p, REPO) for p in paths)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, path in zip(sources, paths):
        with open(path[:-3] + ".log") as f:
            print(f"ptxas {src}: " + " | ".join(l.strip() for l in f if "registers" in l
                                                 or "spill" in l), flush=True)

    # --- 2. kernels against their plain versions ---
    main_case = _case(N_MAIN, seed=0)
    errs, rerrs = [], []
    for case, label in ((main_case, "eval shape"), (_case(45, seed=1), "ragged")):
        err, rerr, _, _ = _check_pair(recon, case, label)
        errs.append(err)
        rerrs.append(rerr)
    special = _case(45, seed=2, special=True)
    err, rerr, (r_sp, _, _, tcc_sp), r_sp2 = _check_pair(recon, special, "sca0/tie/constant-gt")
    errs.append(err)
    rerrs.append(rerr)
    ori0 = torch.from_numpy(special["ori"][0]).cuda()
    if not torch.equal(r_sp[:, 0], ori0.expand(S, T, 2)):
        raise AssertionError("sca == 0 on the moving branch must reconstruct to the origin")
    first_only = [x[..., :1].contiguous() if i < 2 else x
                  for i, x in enumerate(_on(special, "cuda"))]
    tcc_first = recon.fused_recon_metrics(*first_only)[3]
    if abs(float(tcc_sp[1] - tcc_first[1])) > 1e-6 or float(tcc_sp[2]) != 0.0:
        raise AssertionError("FDE tie must score the first sample; constant GT gives TCC 0")

    serve_case = _case(N_SERVE, seed=3)
    err, rerr, _, _ = _check_pair(recon, serve_case, "serving shape")
    errs.append(err)
    rerrs.append(rerr)
    if not torch.equal(r_sp2[:, 0], ori0.expand(S, T, 2)):
        raise AssertionError("fused_reconstruct: sca == 0 must reconstruct to the origin")
    err, rerr = _check_edges(recon)
    errs.append(err)
    rerrs.append(rerr)

    if ab_dir is not None:
        # Each kernel whose source OLD_CSRC_DIR holds.
        sources = {"fused_recon_metrics": recon.SOURCE,
                   "fused_reconstruct": recon.RECONSTRUCT_SOURCE}
        held = lambda source: os.path.exists(os.path.join(ab_dir, source))
        kernels = [k for k in _timed_kernels(main_case, serve_case) if held(sources[k[0]])]
        if not kernels and not held(group.SOURCE):
            raise SystemExit(f"--ab: {ab_dir} holds none of the kernels' sources")
        if kernels:
            _ab(recon, build, ab_dir, card, kernels)
        if held(group.SOURCE):
            _ab_relabel(group, build, ab_dir, card, _relabel_main_inputs(card))
        return

    # --- 3. test() of both models, card against CPU ---
    data = make_synthetic_data(n_scenes=N_SCENES, max_peds=5, seed=0)
    n_peds = int(data.num_peds_in_seq.sum())
    splits = (data, data, data)
    cfgs = {name: load_config(os.path.join(REPO, "configs", path), checkpoint_dir=CKPT_DIR,
                              n_max_peds=N_MAX) for name, path in MODELS}
    trainers, recon_metrics_launches = {}, 0
    for name, cfg in cfgs.items():
        tr = ETTorchTrainer(cfg, tag="parity", datasets=splits, device="cuda")
        tr.load_model()
        tr_cpu = ETTorchTrainer(cfg, tag="parity", datasets=splits, device="cpu")
        tr_cpu.load_model()
        recon_metrics_launches += _check_test(name, tr, tr_cpu, recon)[1]
        trainers[name] = tr

    # --- 3b. fused_col against its plain version; its own launches are not the paths' ---
    col_before = col.LAUNCHES
    col_main_args = _col_main_inputs(trainers["stgcnn"])
    col_err = _check_col(col, card, col_main_args)

    # --- 4. predict() of both models, card against CPU ---
    whole = (data.obs_traj, np.repeat(np.arange(N_SCENES), data.num_peds_in_seq))
    requests = {"(a)": (_walkers(5, seed=11), np.zeros(5, np.int64)),
                "(b)": whole,
                "(c)": (_walkers(150, seed=13), np.zeros(150, np.int64))}
    predictors, reconstruct_launches = {}, 0
    for name, cfg in cfgs.items():
        predictors[name], n = _serve(name, cfg, splits, requests)
        reconstruct_launches += n

    # --- 5. times ---
    times, r_times = (_kernel_times(recon, card, *spec)
                      for spec in _timed_kernels(main_case, serve_case))
    col_times = _col_times(col, card, col_main_args)
    col_side = col.LAUNCHES - col_before - 1     # the main-path test() of 3b counts

    walls = {}
    for name, tr in trainers.items():
        walls[f"test_{name}"] = (_host_times(
            lambda: tr.test(eval_batch=EVAL_BATCH), card,
            f"{name} test() ({n_peds} peds in {EVAL_BATCH}x{N_MAX} slots)", n_peds),
            lambda tr=tr: tr.test(eval_batch=EVAL_BATCH))
    for name, p in predictors.items():
        walls[f"predict_{name}"] = (_host_times(
            lambda: p.predict(*whole), card,
            f"{name} predict() request (b) ({n_peds} peds in {N_SCENES}x{BUCKET} slots)",
            n_peds), lambda p=p: p.predict(*whole))

    if profile_dir is not None:
        for label, (wall_s, fn) in walls.items():
            _profile(label, fn, card, wall_s, profile_dir)

    # --- 7. the training path ---
    recon_metrics_launches += _train_phase(card, cfgs, data, recon, profile_dir)

    # --- 8. the collated regime ---
    n_metrics, n_reconstruct, err, rerr = _collated_phase(card, recon, profile_dir)
    recon_metrics_launches += n_metrics
    reconstruct_launches += n_reconstruct
    errs.append(err)
    rerrs.append(rerr)

    # --- 9. ET-AgentFormer and the reference import ---
    n_metrics, n_reconstruct, err, rerr, (attn_times, attn_err, attn_launches) = \
        _agentformer_phase(card, recon, attention, data, profile_dir)
    recon_metrics_launches += n_metrics
    reconstruct_launches += n_reconstruct
    errs.append(err)
    rerrs.append(rerr)

    # --- 10. ET-DMRGCN and ET-Graph-TERN from the reference's eth weights ---
    n_metrics, n_reconstruct = _multirelational_phase(card, recon, data, profile_dir)
    recon_metrics_launches += n_metrics
    reconstruct_launches += n_reconstruct

    # --- 11. groups and zones: GP-Graph (x2), Social-Implicit; the dense block ---
    counts, relabel_err, relabel_times = _groups_zones_phase(card, recon, group, data,
                                                             profile_dir)
    recon_metrics_launches += counts["recon_metrics"]
    reconstruct_launches += counts["reconstruct"]

    # --- 12. data parallelism: ranks against the single card; the mesh predictor ---
    dp_counts = _data_parallel_phase(card, recon, data)
    recon_metrics_launches += dp_counts["recon_metrics"]
    reconstruct_launches += dp_counts["reconstruct"]
    counts["group"] += dp_counts["group"]
    col_launches = col.LAUNCHES - col_side + dp_counts["col"]

    # --- 13. the native loader on the main path; dormant modules; analysis; the log ---
    recon_metrics_launches += _native_dormant_phase(card, recon)

    def row(name, source, replaces, launches, err, measured):
        return {"name": name, "route": "cuda",
                "source": f"eigentrajectory_tpu_torch/ops/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                **measured, "library_ms": None}

    main_times = relabel_times[(EVAL_BATCH, N_MAX)]

    print(f"[{card}] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        row("fused_recon_metrics", recon.SOURCE, "eigentrajectory_tpu/ops/pallas_recon.py:126",
            recon_metrics_launches, max(errs), times),
        row("fused_reconstruct", recon.RECONSTRUCT_SOURCE,
            "eigentrajectory_tpu/ops/pallas_recon.py:32", reconstruct_launches, max(rerrs),
            r_times),
        # No Pallas kernel: the device loop (lax.fori_loop) of find_group_indices.
        row("group_relabel", group.SOURCE, "eigentrajectory_tpu/models/gpgraph_common.py:30",
            counts["group"], relabel_err,
            {**main_times, "at_301x128": relabel_times[(N_SCENES, BUCKET)],
             "at_1x256": relabel_times[(1, 2 * BUCKET)],
             "all_merge_at_4x57": relabel_times[("all-merge", 4, N_MAX)],
             "all_merge_at_1x256": relabel_times[("all-merge", 1, 2 * BUCKET)]}),
        # No Pallas kernel: metrics.col, which XLA fuses on the TPU.
        row("fused_col", col.SOURCE, "eigentrajectory_tpu/metrics.py:84", col_launches,
            col_err, col_times),
        # No Pallas kernel: AgentAwareAttention, which XLA computes on the TPU.
        row("agent_attention", attention.SOURCE,
            "eigentrajectory_tpu/models/agentformer.py (AgentAwareAttention)",
            attn_launches, attn_err, attn_times)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
