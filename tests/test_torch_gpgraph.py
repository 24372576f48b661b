"""Port vs JAX package: ET-GP-Graph-STGCNN and ET-GP-Graph-SGCN.

The group relabel's plain version bitwise against the JAX package's
`find_group_indices` on random merge matrices (densities 0.05-0.9, padded
slots, N in {1, 2, 5, 33} and the kernel's tier edges 64, 65, 128, 129),
on all-merge and chained-quirk masks at the tier edges; the wrapper's
dispatch and its slot limit; the relabel kernel bitwise against its plain
version on the card (marked `cuda`); pooling,
unpooling and the group mask; the GroupGenerator; both models' eval forward
on blocks of scenes against `vmap` of the JAX model with the JAX init
carried across (<= 1e-4); and `test()` from a checkpoint the JAX trainer
wrote.

Grouping must happen in every case: the learned threshold `th` is set to the
midpoint between two adjacent distinct pair distances of the JAX
`dist_mat` (so that no distance lies within rounding of it), at a quantile
that leaves at least one group of two or more and one singleton, and each
test asserts both.
"""
import functools
import os

import numpy as np
import pytest
import torch

try:        # the reference; the machine with the card lacks flax, and runs `-m cuda` alone
    import jax
    import jax.numpy as jnp

    from eigentrajectory_tpu.config import load_config as jax_load_config
    from eigentrajectory_tpu.models import gpgraph_common as jgc
    from eigentrajectory_tpu.models import gpgraphsgcn as jsgcn
    from eigentrajectory_tpu.models import gpgraphstgcnn as jstgcnn
    from eigentrajectory_tpu.models.common import TorchConv2d as JaxConv2d
    from eigentrajectory_tpu.train.trainer import ETJaxTrainer
except ImportError:
    jax = jsgcn = jstgcnn = None
from eigentrajectory_tpu_torch.config import load_config
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.interop import params_from_jax
from eigentrajectory_tpu_torch.models import gpgraph_common as tgc
from eigentrajectory_tpu_torch.models import gpgraphsgcn as tsgcn
from eigentrajectory_tpu_torch.models import gpgraphstgcnn as tstgcnn
from eigentrajectory_tpu_torch.ops import group, recon
from eigentrajectory_tpu_torch.train import ETTorchTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, S = 6, 20
TOL = dict(atol=1e-4, rtol=1e-4)
MODULES = {"gpgraphstgcnn": (jstgcnn, tstgcnn), "gpgraphsgcn": (jsgcn, tsgcn)}
ET_DUMMY = {"basis_m": {"U_obs": np.zeros((16, K), np.float32),
                        "U_pred": np.zeros((24, K), np.float32)},
            "basis_s": {"U_obs": np.zeros((16, K), np.float32),
                        "U_pred": np.zeros((24, K), np.float32)},
            "anchor_m": np.zeros((K, S), np.float32), "anchor_s": np.zeros((K, S), np.float32)}


class CFG:
    k = K
    num_samples = S


def inputs(rng, counts, n):
    """Coefficients (B, k, n), origins (B, 2, n) and front-contiguous
    validity with counts[b] valid slots in row b; padded slots hold junk."""
    b = len(counts)
    c_obs = rng.normal(size=(b, K, n)).astype(np.float32)
    ori = (3 * rng.normal(size=(b, 2, n))).astype(np.float32)
    valid = np.arange(n)[None, :] < np.asarray(counts)[:, None]
    c_obs[~np.repeat(valid[:, None], K, 1)] = 7.0
    return c_obs, ori, valid


def jax_dist_mats(jm, group_cnn, c_obs, ori, valid):
    """The JAX GroupGenerator's dist_mat (B, N, N) of each scene, from the
    pre-hook's v_abs and the `group_cnn` params."""
    def one(c, o, v):
        v_abs = jm.prepare(c, o, {"ped_valid": v})[0]
        feat = JaxConv2d(1, 8, (3, 1), padding=(1, 0)).apply({"params": group_cnn}, v_abs)
        diff = feat[..., :, None] - feat[..., None, :]
        dist_mat = jnp.mean(jnp.linalg.norm(diff, axis=1)[0], axis=0)
        pair = (v[:, None] & v[None, :]).astype(dist_mat.dtype)
        return dist_mat * pair + (1.0 - pair) * 1e6

    return np.asarray(jax.vmap(one)(jnp.asarray(c_obs), jnp.asarray(ori), jnp.asarray(valid)))


def threshold(dist, valid, q=0.3):
    """The midpoint between two adjacent distinct valid pair distances, at
    quantile q of them."""
    pairs = np.tril(np.ones(dist.shape[1:], bool), -1)[None] & valid[:, :, None] & valid[:, None]
    values = np.unique(dist[pairs])
    i = int(q * (len(values) - 1))
    return float((values[i] + values[i + 1]) / 2)


def assert_groups_form(ranks, valid):
    """At least one group of two or more and one singleton among the valid
    pedestrians of the block."""
    sizes = [np.bincount(r[v]) for r, v in zip(np.asarray(ranks), valid) if v.any()]
    sizes = np.concatenate([s[s > 0] for s in sizes])
    assert (sizes >= 2).any() and (sizes == 1).any(), sizes


def jax_ranks(dist, th, valid):
    ranks, n_groups = jax.vmap(jgc.find_group_indices, in_axes=(0, None, 0))(
        jnp.asarray(dist), jnp.asarray(th, jnp.float32), jnp.asarray(valid))
    return np.asarray(ranks), np.asarray(n_groups)


# ------------------------------------------------------------- the relabel
@pytest.mark.parametrize("n", [1, 2, 5, 33, 64, 65, 128, 129])
def test_relabel_plain_version_is_bitwise_jax_find_group_indices(n):
    """Each scene of the block a density of merges from 0.05 to 0.9 and its
    own count of padded slots; ranks and group counts bit for bit."""
    rng = np.random.default_rng(n)
    densities = (0.05, 0.2, 0.5, 0.9)
    counts = [n, max(n - 1, 0), max(n // 2, 1), n]
    dist = rng.random((4, n, n)).astype(np.float32)
    dist = (dist + dist.transpose(0, 2, 1)) / 2
    valid = np.arange(n)[None] < np.asarray(counts)[:, None]
    for b, d in enumerate(densities):
        dist[b] = dist[b] / d * 0.5                     # a share ~d of pairs at or below 0.5
    want_ranks, want_groups = jax_ranks(dist, 0.5, valid)
    dist_t, valid_t = torch.from_numpy(dist), torch.from_numpy(valid)
    merge = tgc.merge_mask(dist_t, torch.tensor(0.5), valid_t)
    ranks, n_groups = group.group_ranks_plain(merge, valid_t)
    assert ranks.dtype == n_groups.dtype == torch.int32
    np.testing.assert_array_equal(ranks.numpy(), want_ranks)
    np.testing.assert_array_equal(n_groups.numpy(), want_groups)
    got_ranks, got_groups = tgc.find_group_indices(dist_t, torch.tensor(0.5), valid_t)
    assert torch.equal(got_ranks, ranks) and torch.equal(got_groups, n_groups)
    if n >= 5:
        assert_groups_form(ranks, valid)
        assert int(merge.sum()) > n                     # chains of merges, not single pairs


def test_relabel_reproduces_the_raw_column_index_quirk():
    """Merging (2, 1), (3, 0) and (3, 2) in that order: slot 2 takes label
    1, slot 3 label 0, then (3, 2) relabels slot 3's group (label 0) to the
    raw index 2, which is not slot 2's label: two groups, {0, 3} and
    {1, 2}, where union-find would give one."""
    merge = torch.zeros((1, 4, 4), dtype=torch.bool)
    merge[0, 2, 1] = merge[0, 3, 0] = merge[0, 3, 2] = True
    valid = torch.ones((1, 4), dtype=torch.bool)
    ranks, n_groups = group.group_ranks_plain(merge, valid)
    dist = np.where(merge[0].numpy(), 0.0, 1.0).astype(np.float32)
    dist = np.minimum(dist, dist.T)
    want_ranks, want_groups = jax_ranks(dist[None], 0.5, valid.numpy())
    np.testing.assert_array_equal(ranks.numpy(), want_ranks)
    assert ranks.tolist() == [[1, 0, 0, 1]] and int(n_groups) == int(want_groups[0]) == 2


def pattern_dist(pattern, n):
    """(1, n, n) distances that merge (<= 0.5) every pair ("all-merge", N(N-1)/2
    merges in every row: the kernel's longest chain) or a fixed web of pairs whose
    relabels land on raw column indices that are not the row's label
    ("quirk": (r, r - 1), (r, r // 2), and (r, 0) every fifth row)."""
    if pattern == "all-merge":
        return np.zeros((1, n, n), np.float32)
    dist = np.ones((n, n), np.float32)
    for r in range(1, n):
        for c in {r - 1, r // 2} | ({0} if r % 5 == 0 else set()):
            dist[r, c] = dist[c, r] = 0.0
    return dist[None]


@pytest.mark.parametrize("pattern", ["all-merge", "quirk"])
@pytest.mark.parametrize("n", [64, 65, 128, 129])
def test_relabel_plain_version_is_bitwise_jax_on_merge_patterns(pattern, n):
    """The plain version (what the kernel is held to on the card) against
    `find_group_indices` at the kernel's tier edges, the last three slots
    padding."""
    dist = pattern_dist(pattern, n)
    valid = (np.arange(n) < n - 3)[None]
    want_ranks, want_groups = jax_ranks(dist, 0.5, valid)
    dist_t, valid_t = torch.from_numpy(dist), torch.from_numpy(valid)
    merge = tgc.merge_mask(dist_t, torch.tensor(0.5), valid_t)
    if pattern == "all-merge":
        assert int(merge.sum()) == (n - 3) * (n - 4) // 2
    ranks, n_groups = group.group_ranks_plain(merge, valid_t)
    np.testing.assert_array_equal(ranks.numpy(), want_ranks)
    np.testing.assert_array_equal(n_groups.numpy(), want_groups)
    assert int(n_groups[0]) == (4 if pattern == "all-merge" else int(want_groups[0]))


def test_the_kernel_wrapper_refuses_more_slots_than_a_block_holds():
    """MAX_SLOTS is the largest N whose labels, presence map with its prefix
    counts and one staged row of merge bits (with its last column and the
    row bits) fit in 227 KB of shared memory; one more slot is refused
    before any device check."""
    words = lambda k: k + 2 * -(-k // 32) + 2 * -(-k // 16) + 1
    n = group.MAX_SLOTS
    assert words(n) <= 227 * 1024 // 4 < words(n + 1)
    for slots, match in ((n + 1, "at most 48933 slots"), (n, "CUDA or CPU")):
        merge = torch.ones((1, slots, slots), dtype=torch.bool, device="meta")
        valid = torch.ones((1, slots), dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match=match):
            group.group_ranks(merge, valid)


def test_the_wrapper_dispatches_on_the_tensors_device():
    """CPU tensors take the plain version without a launch; tensors on
    another device than the card or the CPU are refused."""
    rng = np.random.default_rng(0)
    dist = torch.from_numpy(rng.random((3, 6, 6)).astype(np.float32))
    valid = torch.ones((3, 6), dtype=torch.bool)
    merge = tgc.merge_mask(dist, torch.tensor(0.4), valid)
    before = group.LAUNCHES
    got = group.group_ranks(merge, valid)
    want = group.group_ranks_plain(merge, valid)
    assert group.LAUNCHES == before and all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        group.group_ranks(merge.to("meta"), valid.to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,pattern", [
    (320, 57, "random"), (3, 31, "random"), (3, 32, "random"), (3, 33, "random"),
    (2, 1025, "random"), (3, 64, "random"), (3, 65, "random"), (3, 128, "random"),
    (3, 129, "random"), (3, 256, "random"), (3, 257, "random"), (1, 256, "random"),
    (4, 57, "all-merge"), (1, 256, "all-merge"), (2, 129, "quirk")])
def test_group_relabel_kernel_is_bitwise_its_plain_version(cuda_device, b, n, pattern):
    """Random masks (each scene its own count of valid slots), at the edges
    of the kernel's register tiers (64, 128, 256 slots) and past them, and
    the all-merge mask: every valid pair merges, the longest chain."""
    rng = np.random.default_rng(n)
    if pattern == "random":
        dist = torch.from_numpy(rng.random((b, n, n)).astype(np.float32))
    else:
        dist = torch.from_numpy(np.repeat(pattern_dist(pattern, n), b, axis=0))
    valid = torch.from_numpy(np.arange(n)[None] < rng.integers(1, n + 1, size=(b, 1)))
    merge = tgc.merge_mask(dist, torch.tensor(min(0.3, 20.0 / n)), valid)
    want = group.group_ranks_plain(merge, valid)
    before = group.LAUNCHES
    got = group.group_ranks(merge.to(cuda_device), valid.to(cuda_device))
    torch.cuda.synchronize()
    assert group.LAUNCHES == before + 1
    assert all(torch.equal(a.cpu(), w) for a, w in zip(got, want))


# ------------------------------------------------ pooling and the generator
def test_pool_unpool_and_mask_match_jax():
    rng = np.random.default_rng(1)
    n = 7
    dist = rng.random((3, n, n)).astype(np.float32)
    dist = (dist + dist.transpose(0, 2, 1)) / 2
    valid = np.arange(n)[None] < np.array([[7], [5], [2]])
    ranks, _ = jax_ranks(dist, 0.35, valid)
    assert_groups_form(ranks, valid)
    v = rng.normal(size=(3, 2, 8, n)).astype(np.float32)
    r_t = torch.from_numpy(ranks.copy())
    pooled = tgc.ped_group_pool(torch.from_numpy(v), r_t).numpy()
    for b in range(3):
        want = np.asarray(jgc.ped_group_pool(jnp.asarray(v[b:b + 1]), jnp.asarray(ranks[b])))
        np.testing.assert_allclose(pooled[b:b + 1], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(
            tgc.ped_group_unpool(torch.from_numpy(pooled), r_t).numpy()[b:b + 1],
            np.asarray(jgc.ped_group_unpool(jnp.asarray(pooled[b:b + 1]), jnp.asarray(ranks[b]))))
        np.testing.assert_array_equal(tgc.ped_group_mask(r_t).numpy()[b],
                                      np.asarray(jgc.ped_group_mask(jnp.asarray(ranks[b]))))


@functools.lru_cache(maxsize=None)
def _jax_init(name, n=6):
    """The JAX model's initial variables (jitted: eager init of the SGCN
    takes twice as long); callers copy what they change."""
    jm = MODULES[name][0]
    model = jm.make_model(CFG)
    inputs_ = jm.prepare(jnp.ones((K, n)), jnp.zeros((2, n)), {"ped_valid": jnp.ones(n, bool)})
    variables = jax.jit(lambda key, *a: model.init(key, *a, train=False))(
        jax.random.PRNGKey(7), *inputs_)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _with_th(variables, th):
    params = {**variables["params"]}
    params["group_gen"] = {**params["group_gen"], "th": np.array([th], np.float32)}
    return {**variables, "params": params}


def _torch_model(name, variables):
    state, _ = params_from_jax({**variables, "et": ET_DUMMY})
    model = MODULES[name][1].make_model(CFG)
    missing, unexpected = model.load_state_dict(state, strict=False)
    unused = getattr(model, "unused_prefixes", lambda: ())()
    assert not unexpected and all(k.startswith(unused) for k in missing)
    return model.eval()


def test_group_generator_matches_jax():
    """v_hard within 1e-5, ranks and group counts bit for bit."""
    rng = np.random.default_rng(2)
    variables = _jax_init("gpgraphsgcn")
    c_obs, ori, valid = inputs(rng, [8, 6, 3], 8)
    gcn = variables["params"]["group_gen"]["group_cnn"]
    th = threshold(jax_dist_mats(jsgcn, gcn, c_obs, ori, valid), valid)
    gen = jgc.GroupGenerator(in_channels=1, hid_channels=8)
    jvars = {"params": {"group_cnn": gcn, "th": np.array([th], np.float32)}}

    def one(c, o, v):
        v_abs, v_rel, _ = jsgcn.prepare(c, o, {"ped_valid": v})
        return gen.apply(jvars, v_rel, v_abs, v)

    want_v, want_ranks, want_groups = (np.asarray(x) for x in jax.vmap(one)(
        jnp.asarray(c_obs), jnp.asarray(ori), jnp.asarray(valid)))
    assert_groups_form(want_ranks, valid)
    tg = tgc.GroupGenerator(1, 8)
    tg.load_state_dict({"group_cnn.weight": torch.tensor(gcn["kernel"]),
                        "group_cnn.bias": torch.tensor(gcn["bias"]),
                        "th": torch.tensor([th])})
    v_abs, v_rel, v_t = tsgcn.prepare(torch.from_numpy(c_obs), torch.from_numpy(ori),
                                       {"ped_valid": torch.from_numpy(valid)})
    with torch.no_grad():
        got_v, ranks, n_groups = tg(v_rel, v_abs, v_t)
    np.testing.assert_array_equal(ranks.numpy(), want_ranks)
    np.testing.assert_array_equal(n_groups.numpy(), want_groups)
    np.testing.assert_allclose(got_v.numpy(), want_v[:, 0], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------- the forwards
@pytest.mark.parametrize("name", ["gpgraphstgcnn", "gpgraphsgcn"])
def test_eval_forward_on_a_block_matches_vmap_of_the_jax_model(name):
    """Three scenes of 8, 6 and 3 in 8 slots and an empty row, train=False,
    the JAX init carried across: (B, k, N, s) within 1e-4 on the valid
    slots; each scene alone in its own width gives its rows of the block."""
    jm, tm = MODULES[name]
    rng = np.random.default_rng(3)
    variables = _jax_init(name)
    c_obs, ori, valid = inputs(rng, [8, 6, 3, 0], 8)
    gcn = variables["params"]["group_gen"]["group_cnn"]
    th = threshold(jax_dist_mats(jm, gcn, c_obs, ori, valid), valid)
    variables = _with_th(variables, th)
    model = jm.make_model(CFG)

    def one(c, o, v):
        aux = {"ped_valid": v}
        out = model.apply(variables, *jm.prepare(c, o, aux), train=False)
        return jm.finalize(out, aux)

    want = np.asarray(jax.vmap(one)(jnp.asarray(c_obs), jnp.asarray(ori), jnp.asarray(valid)))
    ranks, _ = jax_ranks(jax_dist_mats(jm, gcn, c_obs, ori, valid), th, valid)
    assert_groups_form(ranks, valid)

    tmodel = _torch_model(name, variables)

    def run(c, o, v):
        aux = {"ped_valid": torch.from_numpy(v)}
        with torch.no_grad():
            return tm.finalize(tmodel(*tm.prepare(torch.from_numpy(c), torch.from_numpy(o),
                                                  aux)), aux).numpy()

    got = run(c_obs, ori, valid)
    assert got.shape == (4, K, 8, S) and np.isfinite(got).all()
    for b in range(3):
        np.testing.assert_allclose(got[b][:, valid[b]], want[b][:, valid[b]],
                                   err_msg=f"scene {b}", **TOL)
    m = int(valid[1].sum())
    alone = run(c_obs[1:2, :, :m], ori[1:2, :, :m], valid[1:2, :m])
    np.testing.assert_allclose(alone[0], got[1][:, :m], atol=2e-5)


# ---------------------------------------------------------------- test()
@pytest.mark.parametrize("name", ["gpgraphstgcnn", "gpgraphsgcn"])
def test_test_means_from_a_jax_checkpoint_match_jax(tmp_path, name):
    """test() of a checkpoint the JAX trainer wrote (its descriptor fit and
    initial weights, th = 1 from the init), read by load_model(): the means
    within 1e-4, through the plain versions of the kernels on the CPU."""
    data = tuple(make_synthetic_data(n_scenes=n, max_peds=6, seed=seed)
                 for n, seed in ((9, 1), (5, 2), (7, 3)))
    path = os.path.join(REPO, "configs", f"eigentrajectory-{name}-hotel.json")
    kw = dict(checkpoint_dir=str(tmp_path), batch_size=4, static_dist=0.3)
    jtr = ETJaxTrainer(jax_load_config(path, **kw), tag="jax", test_mode=True, datasets=data)
    jtr.init_descriptor()
    jtr.save_model()
    ttr = ETTorchTrainer(load_config(path, **kw), tag="jax", datasets=data, device="cpu")
    ttr.load_model()
    want = jtr.test(eval_batch=4)
    launches = (recon.LAUNCHES, group.LAUNCHES)
    got = ttr.test(eval_batch=4)
    assert (recon.LAUNCHES, group.LAUNCHES) == launches
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert np.isfinite(list(got.values())).all() and 0.0 < got["ADE"]
