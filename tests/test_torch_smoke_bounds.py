"""The yardstick of chip_smoke.py, pinned on the CPU: the least time the card
could take for each kernel's work is computed from the run's inputs as bytes
over the H100's memory rate (each input read once, each output written once,
one coefficient branch a pedestrian) or f32 operations over its f32 rate,
whichever is larger. The script imports torch only inside its functions, so
it can be imported where there is no card."""
import numpy as np
import pytest

import chip_smoke

K, S, T = 6, 20, 12


def _bytes(n, n_bases, gt):
    """Bytes by hand: one branch's coefficients, the bases in use, ori, rot,
    sca and the mask in; the trajectories (and GT in, three metrics out)."""
    read = n * K * S * 4 + n_bases * 2 * T * K * 4 + n * (8 + 16 + 4 + 1)
    write = n * S * T * 2 * 4
    if gt:
        read += n * T * 2 * 4
        write += 3 * n * 4
    return read + write


def test_widths_are_the_kernels():
    assert (chip_smoke.K, chip_smoke.S, chip_smoke.T) == (K, S, T)
    assert chip_smoke.N_MAIN == 18240 and chip_smoke.N_SERVE == 38528
    assert chip_smoke.PEAK_BYTES_PER_S == 3.35e12 and chip_smoke.PEAK_F32_PER_S == 67e12


def test_recon_metrics_bound_at_the_eval_shape():
    case = chip_smoke._case(chip_smoke.N_MAIN, seed=0)
    ms, by = chip_smoke._recon_metrics_bound_ms(case)
    total = _bytes(18240, 2, gt=True)
    assert total == 46276032                       # the 46.3 MB of PERF.md's table
    assert by == "bytes"
    assert ms == pytest.approx(total / 3.35e12 * 1e3, rel=1e-12)
    assert round(ms, 4) == 0.0138


def test_reconstruct_bound_at_the_serving_shape():
    case = chip_smoke._case(chip_smoke.N_SERVE, seed=3)
    ms, by = chip_smoke._reconstruct_bound_ms(case)
    total = _bytes(38528, 2, gt=False)
    assert total == 93585664                       # the 93.6 MB of PERF.md's table
    assert by == "bytes"
    assert ms == pytest.approx(total / 3.35e12 * 1e3, rel=1e-12)
    assert round(ms, 4) == 0.0279


@pytest.mark.parametrize("mask,n_bases", [(None, 2), (True, 1), (False, 1)])
def test_bound_counts_one_branch_a_pedestrian(mask, n_bases):
    """A mixed mask reads one coefficient branch for each pedestrian, not
    both, and both bases; an all-moving or all-static one a single basis."""
    n = 109
    case = chip_smoke._case(n, seed=1, mask=mask)
    assert (0 < case["mask"].sum() < n) == (mask is None)
    assert chip_smoke._recon_bytes_in(case) == (
        n * K * S * 4 + n_bases * 2 * T * K * 4 + n * 29)
    ms, _ = chip_smoke._reconstruct_bound_ms(case)
    assert ms == pytest.approx(_bytes(n, n_bases, gt=False) / 3.35e12 * 1e3, rel=1e-12)
    ms, _ = chip_smoke._recon_metrics_bound_ms(case)
    assert ms == pytest.approx(_bytes(n, n_bases, gt=True) / 3.35e12 * 1e3, rel=1e-12)


def test_bound_turns_to_operations_when_they_take_longer():
    assert chip_smoke._bound(read=4, write=4, ops=1e9) == (1e9 / 67e12 * 1e3, "operations")
    assert chip_smoke._bound(read=1e9, write=0, ops=10)[1] == "bytes"


def test_case_is_made_from_its_seed():
    a, b = chip_smoke._case(40, seed=5), chip_smoke._case(40, seed=5)
    assert all(np.array_equal(a[key], b[key]) for key in a)
    assert all(v.dtype == (bool if key == "mask" else np.float32) for key, v in a.items())
    assert not np.array_equal(a["c_m"], chip_smoke._case(40, seed=6)["c_m"])


def test_relabel_bound_counts_the_masks_bytes_and_the_merges_that_fire():
    """The group relabel's yardstick: the strictly lower triangle of merge
    (B*N(N-1)/2 bytes: the rest is zero by contract and is not read) and
    valid in, ranks and n_groups (int32) out; operations the tests of the
    pairs' merge bits, N compares a row holding a merge and the 4N presence
    and prefix pass a scene, against the f32 rate. At the eval shape the
    bytes bound it."""
    import torch

    b, n = 320, 57
    merge = torch.zeros((b, n, n), dtype=torch.bool)
    merge[:, 3, 1] = merge[:5, 9, 2] = True
    valid = torch.ones((b, n), dtype=torch.bool)
    ms, by = chip_smoke._relabel_bound_ms(merge, valid)
    total = b * n * (n - 1) // 2 + b * n + 4 * b * n + 4 * b
    ops = b * n * (n - 1) // 2 + (b + 5) * n + b * 4 * n
    assert by == "bytes" and total / 3.35e12 > ops / 67e12
    assert ms == pytest.approx(total / 3.35e12 * 1e3, rel=1e-12)


def _all_merge(b, n):
    """Every pair of the strictly lower triangle merges, all slots valid."""
    import torch

    merge = torch.ones((b, n, n), dtype=torch.bool).tril(-1)
    return merge, torch.ones((b, n), dtype=torch.bool)


def _one_row(b, n):
    """Scene 0's row n - 1 merges with every earlier slot, scene 1's row 5
    with slot 2: n - 1 + 1 merges in two rows."""
    import torch

    merge = torch.zeros((b, n, n), dtype=torch.bool)
    merge[0, n - 1, :n - 1] = True
    merge[1, 5, 2] = True
    return merge, torch.ones((b, n), dtype=torch.bool)


@pytest.mark.parametrize("make,b,n,rows", [(_all_merge, 1, 256, 255), (_all_merge, 4, 57, 4 * 56),
                                           (_one_row, 3, 150, 2)])
def test_relabel_bound_counts_a_step_a_row_holding_a_merge(monkeypatch, make, b, n, rows):
    """A row's merges chain through the row's own label and collapse into
    one N-wide compare-and-select (group_relabel.cu's note), so the bound
    counts N operations a row holding a merge, not a merge: the all-merge
    (1, 256) mask is bound by its bytes, not by 32,640 merges x 256."""
    merge, valid = make(b, n)
    assert int(merge.any(dim=-1).sum()) == rows and int(merge.sum()) >= rows
    seen = {}
    real = chip_smoke._bound

    def noting(read, write, ops):
        seen.update(read=read, write=write, ops=ops)
        return real(read, write, ops)

    monkeypatch.setattr(chip_smoke, "_bound", noting)
    ms, by = chip_smoke._relabel_bound_ms(merge, valid)
    assert seen == {"read": b * n * (n - 1) // 2 + b * n, "write": 4 * b * n + 4 * b,
                    "ops": b * n * (n - 1) // 2 + rows * n + 4 * b * n}
    assert by == "bytes"
    assert ms == pytest.approx((seen["read"] + seen["write"]) / 3.35e12 * 1e3, rel=1e-12)
    if (b, n) == (1, 256):
        assert seen["read"] + seen["write"] == 33924 and round(ms, 8) == 1.013e-05


@pytest.mark.parametrize("gathered", [False, True])
def test_col_bound_counts_the_valid_walkers_and_pairs_alone(monkeypatch, gathered):
    """fused_col's least time reads the mask, 5 positions a (sample, valid
    walker) (and its gather entry) and writes COL a slot; it counts the
    window a (sample, valid walker) and 14 distances a (sample, valid pair):
    padding costs its mask and output bytes only."""
    import torch

    valid = torch.zeros(4, 57, dtype=torch.bool)
    valid[0, :2], valid[1, :5], valid[3, :57] = True, True, True
    n, pairs = 2 + 5 + 57, 1 + 10 + 57 * 56 // 2
    seen = {}
    real = chip_smoke._bound

    def noting(read, write, ops):
        seen.update(read=read, write=write, ops=ops)
        return real(read, write, ops)

    monkeypatch.setattr(chip_smoke, "_bound", noting)
    gather = torch.zeros(4, 57, dtype=torch.long) if gathered else None
    ms, by = chip_smoke._col_bound_ms(valid, gather)
    assert seen == {"read": 4 * 57 + n * S * 40 + (8 * n if gathered else 0),
                    "write": 4 * 57 * 4, "ops": S * (n * 42 + pairs * 98)}
    assert by == "operations"
    assert ms == pytest.approx(seen["ops"] / 67e12 * 1e3, rel=1e-12)
