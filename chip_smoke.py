"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile OUT_DIR]

Run from the root of the repository on a machine with an NVIDIA H100 and the
CUDA toolkit. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernel from `eigentrajectory_tpu_torch/ops/csrc`
   and holds `fused_recon_metrics` against its plain PyTorch version on the
   card at the main path's shape (k=6, S=20, T=12, N=320*57), at a ragged N,
   and on a case with sca == 0, an FDE tie and a constant-GT pedestrian
   (atol = rtol = 1e-4: the sums run in another order);
3. drives the main path, `ETTorchTrainer.test()` of ET-STGCNN on the hotel
   configuration with the committed hotel checkpoint, on a synthetic test
   split sized like hotel's (301 scenes, ~1,050 pedestrians) in one padded
   block of 320 x 57 slots; checks that the kernel ran, that the metrics are
   finite, and that the same run on the CPU agrees within 1e-4;
4. times the kernel, its plain version and test() with CUDA events and the
   host clock, beside the least time the card could take for the kernel's
   work;
5. prints a JSON line with the kernel's numbers, then as its last line
   {"ok": true, "device": {...}}.

`--profile OUT_DIR` also profiles one test() run with torch.profiler and
writes its table to OUT_DIR/profile_test.txt. Any failure raises and the
exit code is not 0; without a CUDA device the script fails before it
prints a result.
"""
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CFG_PATH = os.path.join(REPO, "configs", "eigentrajectory-stgcnn-hotel.json")
ATOL = RTOL = 1e-4
K, S, T = 6, 20, 12
EVAL_BATCH, N_MAX = 320, 57            # one padded block, as bench.py times it
N_MAIN = EVAL_BATCH * N_MAX
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 rate and f32
# rate outside the tensor cores, at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _case(n, seed, special=False):
    """Kernel inputs as numpy arrays. `special` adds a moving ped with
    sca == 0 (ped 0), a ped whose samples all end at one point so that the
    FDE ties (ped 1) and a constant-GT ped (ped 2)."""
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


def _check_kernel(recon, case, label):
    """Kernel vs plain version on the card; returns the max abs error.

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
    print(f"kernel check {label}: N={case['c_m'].shape[1]} max_abs_err={err:.3e} "
          f"(atol=rtol={ATOL}; TCC on {int(clear.sum())} peds with a clear best sample)",
          flush=True)
    return err, got


def _event_ms(fn, iters):
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


def _bound_ms(case):
    """Least time for the kernel's work on these inputs: each input byte the
    outputs need read once (the coefficients of the selected branch only),
    each output byte written once, against the memory rate; the f32
    operations against the f32 rate. Returns (ms, "bytes" or "operations")."""
    n = case["c_m"].shape[1]
    moving = int(case["mask"].sum())
    read = (K * S * 4 * n                     # c of the branch each ped uses
            + 2 * T * K * 4 * (2 if 0 < moving < n else 1)
            + n * (T * 2 * 4 + 8 + 16 + 4 + 1))   # gt, ori, rot, sca, mask
    write = S * n * T * 2 * 4 + 3 * n * 4
    # per ped and sample: 2T*K FMAs, scale, rotate+translate (4 mul/add + 2
    # add per step), distance (5 per step); TCC per ped ~ 8 per step.
    ops = n * S * T * (2 * 2 * K + 2 + 6 + 5) + n * T * 8
    t_bytes = (read + write) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _profile(tr, card, wall_s, out_dir):
    """One test() under torch.profiler: the table goes to
    out_dir/profile_test.txt, the kernel time of each span of the eval step
    and the device's busy share of the unprofiled median wall time to
    stdout."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.test(eval_batch=EVAL_BATCH)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    # Kernel time launched inside each span of the trainer (the CPU-side range;
    # its GPU-side twin measures the range's extent on the device timeline).
    spans = {}
    for e in prof.events():
        if e.name.startswith("eval.") and e.device_type == DeviceType.CPU:
            spans[e.name] = spans.get(e.name, 0.0) + e.device_time_total
    os.makedirs(out_dir, exist_ok=True)
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, "profile_test.txt"), "w") as f:
        f.write(f"{card}\n{table}\n")
    print(f"[{card}] profiled test(): device busy {busy_us / 1e3:.3f} ms = "
          f"{busy_us / 1e3 / (wall_s * 1e3):.1%} of the median wall; kernel ms by span "
          + json.dumps({k: round(v / 1e3, 4) for k, v in sorted(spans.items())}), flush=True)


def main(argv):
    import torch

    profile_dir = None
    if argv[:1] == ["--profile"] and len(argv) == 2:
        profile_dir = argv[1]
    elif argv:
        raise SystemExit("usage: python3 chip_smoke.py [--profile OUT_DIR]")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs only on the card")

    from eigentrajectory_tpu_torch.config import load_config
    from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
    from eigentrajectory_tpu_torch.ops import build, recon
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)

    # --- 1. build ---
    t0 = time.perf_counter()
    lib_path = build.build(recon.SOURCE)
    print(f"built {os.path.relpath(lib_path, REPO)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    with open(lib_path[:-3] + ".log") as f:
        print("ptxas: " + " | ".join(l.strip() for l in f if "registers" in l
                                      or "spill" in l), flush=True)

    # --- 2. kernel against its plain version ---
    main_case = _case(N_MAIN, seed=0)
    errs = [_check_kernel(recon, main_case, "main-path shape")[0],
            _check_kernel(recon, _case(45, seed=1), "ragged")[0]]
    special = _case(45, seed=2, special=True)
    err, (r_sp, _, _, tcc_sp) = _check_kernel(recon, special, "sca0/tie/constant-gt")
    errs.append(err)
    ori0 = torch.from_numpy(special["ori"][0]).cuda()
    if not torch.equal(r_sp[:, 0], ori0.expand(S, T, 2)):
        raise AssertionError("sca == 0 on the moving branch must reconstruct to the origin")
    first_only = [x[..., :1].contiguous() if i < 2 else x
                  for i, x in enumerate(_on(special, "cuda"))]
    tcc_first = recon.fused_recon_metrics(*first_only)[3]
    if abs(float(tcc_sp[1] - tcc_first[1])) > 1e-6 or float(tcc_sp[2]) != 0.0:
        raise AssertionError("FDE tie must score the first sample; constant GT gives TCC 0")

    # --- 3. the main path ---
    cfg = load_config(CFG_PATH, checkpoint_dir=os.path.join(REPO, "checkpoints"),
                      n_max_peds=N_MAX)
    data = make_synthetic_data(n_scenes=301, max_peds=5, seed=0)
    n_peds = int(data.num_peds_in_seq.sum())
    splits = (data, data, data)
    tr = ETTorchTrainer(cfg, tag="parity", datasets=splits, device="cuda")
    tr.load_model()
    recon.LAUNCHES = 0
    res = tr.test(eval_batch=EVAL_BATCH)
    torch.cuda.synchronize()
    launches = recon.LAUNCHES
    print(f"test() on the card: {res} over {n_peds} peds, "
          f"fused_recon_metrics launches={launches}", flush=True)
    if launches < 1:
        raise AssertionError("the main path did not launch fused_recon_metrics")
    if not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"non-finite metrics {res}")
    tr_cpu = ETTorchTrainer(cfg, tag="parity", datasets=splits, device="cpu")
    tr_cpu.load_model()
    res_cpu = tr_cpu.test(eval_batch=EVAL_BATCH)
    print(f"test() on the CPU:  {res_cpu}", flush=True)
    for key, want in res_cpu.items():
        if not abs(res[key] - want) <= ATOL + RTOL * abs(want):
            raise AssertionError(f"{key}: card {res[key]} vs CPU {want}")

    # --- 4. times ---
    args = _on(main_case, "cuda")
    kernel_ms = _event_ms(lambda: recon.fused_recon_metrics(*args), 50)
    plain_ms = _event_ms(lambda: recon.fused_recon_metrics_plain(*args), 10)
    bound_ms, bound_by = _bound_ms(main_case)
    print(f"[{card}] fused_recon_metrics N={N_MAIN}: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    for _ in range(5):
        tr.test(eval_batch=EVAL_BATCH)
    walls = []
    for _ in range(50):
        t0 = time.perf_counter()
        tr.test(eval_batch=EVAL_BATCH)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    walls.sort()
    median, p80 = walls[len(walls) // 2], walls[39]   # 10 samples above p80
    print(f"[{card}] test() wall over {len(walls)} runs: median {median * 1e3:.3f} ms, "
          f"p80 {p80 * 1e3:.3f} ms, min {walls[0] * 1e3:.3f} ms; "
          f"{n_peds / median:.1f} trajectories/s at the median "
          f"({n_peds} peds in {EVAL_BATCH}x{N_MAX} slots)", flush=True)

    if profile_dir is not None:
        _profile(tr, card, median, profile_dir)

    print(json.dumps({"kernels": [{
        "name": "fused_recon_metrics", "route": "cuda",
        "source": "eigentrajectory_tpu_torch/ops/csrc/recon_metrics.cu",
        "replaces": "eigentrajectory_tpu/ops/pallas_recon.py:126",
        "launches": launches, "max_abs_err": max(errs),
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
