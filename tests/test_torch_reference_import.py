"""Port vs JAX package: the import of the reference's own checkpoints.

`benchmarks/ref_resume/sgcn-zara1.pt` is a training snapshot of the
reference; its `best_model` field holds the bytes of the reference's
`model_best.pth`, a state dict with `baseline_model.*` and ET keys. The
port's `import_state_dict` must give, bit for bit, what the JAX package's
`import_state_dict` followed by `params_from_jax` gives: on that file, and
for the other converters (GP-Graph's and Implicit's included) on synthetic
state dicts keyed as the JAX converters read them. The same holds for ET-DMRGCN and ET-Graph-TERN on the
eth snapshots (`dmrgcn-eth.pt`, `graphtern-eth.pt`). The imported models
evaluate as the JAX package does, and the CLI writes a checkpoint the
port's trainer reads.
"""
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from eigentrajectory_tpu import interop as jinterop
from eigentrajectory_tpu.config import load_config as jax_load_config
from eigentrajectory_tpu.train.trainer import ETJaxTrainer
from eigentrajectory_tpu_torch import interop
from eigentrajectory_tpu_torch.config import ExpConfig, load_config
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.interop import import_state_dict, params_from_jax
from eigentrajectory_tpu_torch.models import get_baseline
from eigentrajectory_tpu_torch.train import ETTorchTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "benchmarks", "ref_resume", "sgcn-zara1.pt")
ZARA1_CFG = os.path.join(REPO, "configs", "eigentrajectory-sgcn-zara1.json")
ET_KEYS = {"ET_m_descriptor.U_obs_trunc": (16, 6), "ET_m_descriptor.U_pred_trunc": (24, 6),
           "ET_s_descriptor.U_obs_trunc": (16, 6), "ET_s_descriptor.U_pred_trunc": (24, 6),
           "ET_m_anchor.C_anchor": (6, 20), "ET_s_anchor.C_anchor": (6, 20)}


def best_model_bytes() -> bytes:
    """The reference's model_best.pth inside the committed snapshot (the
    snapshot also holds numpy RNG states, which the restricted unpickler
    refuses; it is a file of this repository)."""
    return torch.load(SNAPSHOT, map_location="cpu", weights_only=False)["best_model"]


@pytest.fixture(scope="module")
def reference_sd():
    return torch.load(io.BytesIO(best_model_bytes()), map_location="cpu", weights_only=True)


def _jax_path(baseline, sd):
    """The JAX package's import, then the port's mapping of its tree."""
    params, batch_stats, et = jinterop.import_state_dict(baseline, sd)
    tree = {"params": jax.tree_util.tree_map(np.asarray, params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, batch_stats),
            "et": {"basis_m": {"U_obs": np.asarray(et.basis_m.U_obs),
                               "U_pred": np.asarray(et.basis_m.U_pred)},
                   "basis_s": {"U_obs": np.asarray(et.basis_s.U_obs),
                               "U_pred": np.asarray(et.basis_s.U_pred)},
                   "anchor_m": np.asarray(et.anchor_m), "anchor_s": np.asarray(et.anchor_s)}}
    return params_from_jax(tree)


def _assert_bitwise(got, want):
    (state, et), (want_state, want_et) = got, want
    assert sorted(state) == sorted(want_state)
    for name, value in want_state.items():
        assert state[name].dtype == value.dtype and state[name].shape == value.shape, name
        assert state[name].numpy().tobytes() == value.numpy().tobytes(), name
    for a, b in zip((*et.basis_m, *et.basis_s, et.anchor_m, et.anchor_s),
                    (*want_et.basis_m, *want_et.basis_s, want_et.anchor_m, want_et.anchor_s)):
        assert torch.equal(a, b)


def test_the_sgcn_snapshot_imports_bitwise_as_the_jax_package_imports_it(reference_sd):
    assert len(reference_sd) == 103
    got = import_state_dict("sgcn", reference_sd)
    _assert_bitwise(got, _jax_path("sgcn", reference_sd))
    model = get_baseline("sgcn").make_model(ExpConfig(baseline="sgcn"))
    model.load_state_dict(got[0])                    # strict: every parameter filled
    np.testing.assert_array_equal(got[1].anchor_m.numpy(),
                                  reference_sd["ET_m_anchor.C_anchor"].numpy())


# --- synthetic reference state dicts: the port's names -> the reference's,
# as the JAX converters read them (eigentrajectory_tpu/interop.py:70-295)
_STGCNN = [(r"^st_gcn_0\.gcn_conv\.", "st_gcns.0.gcn.conv."),
           (r"^st_gcn_0\.tcn_bn1\.", "st_gcns.0.tcn.0."),
           (r"^st_gcn_0\.tcn_prelu\.", "st_gcns.0.tcn.1."),
           (r"^st_gcn_0\.tcn_conv\.", "st_gcns.0.tcn.2."),
           (r"^st_gcn_0\.tcn_bn2\.", "st_gcns.0.tcn.3."),
           (r"^st_gcn_0\.res_conv\.", "st_gcns.0.residual.0."),
           (r"^st_gcn_0\.res_bn\.", "st_gcns.0.residual.1."),
           (r"^st_gcn_0\.out_prelu\.", "st_gcns.0.prelu."),
           (r"^tpcnn_output\.", "tpcnn_ouput."),
           (r"^tpcnn_(\d)\.", r"tpcnns.\1."), (r"^prelu_(\d)\.", r"prelus.\1.")]
_MLP = [(r"\.layer_(\d)\.", r".layers.\1.")]
_AGENTFORMER = [(r"^ctx_input_fc\.", "context_encoder.input_fc."),
                (r"^ctx_pos_encoder\.", "context_encoder.pos_encoder."),
                (r"^dec_input_fc\.", "future_decoder.input_fc."),
                (r"^dec_pos_encoder\.", "future_decoder.pos_encoder."),
                (r"^enc_layer_(\d)\.", r"context_encoder.tf_encoder.layers.\1."),
                (r"^dec_layer_(\d)\.", r"future_decoder.tf_decoder.layers.\1."),
                (r"\.in_proj\.(weight|bias)$", r".in_proj_\1"),
                (r"\.in_proj_self\.(weight|bias)$", r".in_proj_\1_self"),
                (r"\.in_proj_kernel$", ".in_proj_weight"),
                (r"\.in_proj_self_kernel$", ".in_proj_weight_self"),
                (r"\.in_proj_self_bias$", ".in_proj_bias_self"),
                (r"^out_fc_kernel$", "future_decoder.out_fc.weight"),
                (r"^out_fc_bias$", "future_decoder.out_fc.bias")]
_SGCN = [(r"^sparse_adjacency\.spa_fusion_conv\.", "sparse_weighted_adjacency_matrices.spa_fusion.conv.0."),
         (r"^sparse_adjacency\.spa_fusion_prelu\.", "sparse_weighted_adjacency_matrices.spa_fusion.conv.1."),
         (r"^sparse_adjacency\.interaction_mask\.(spatial|temporal)_(\d)\.",
          r"sparse_weighted_adjacency_matrices.interaction_mask.\1_asymmetric_convolutions.\2."),
         (r"^sparse_adjacency\.", "sparse_weighted_adjacency_matrices."),
         (r"^stsgcn\.st_gcn_(\d)\.", r"stsgcn.spatial_temporal_sparse_gcn.\1."),
         (r"^stsgcn\.ts_gcn_(\d)\.", r"stsgcn.temporal_spatial_sparse_gcn.\1."),
         (r"^fusion\.", "fusion_."), (r"^tcn_prelu_(\d)\.", r"tcns.\1.1."),
         (r"^tcn_(\d)\.", r"tcns.\1.0.")]


def _gpgraph(inner):
    """The GPGraph wrapper's names around a baseline's rules."""
    return [(r"^group_gen\.group_cnn\.", "group_gen.group_cnn.0."),
            (r"^group_mix\.mix_prelu\.", "group_mix.st_gcns_mix.0."),
            (r"^group_mix\.mix_conv\.", "group_mix.st_gcns_mix.1.")] + \
        [(r"^baseline_model\." + pattern[1:], "baseline_model." + repl) for pattern, repl in inner]


_IMPLICIT = [(r"^cell_(\d)\.", r"implicit_cells.\1."), (r"\.ped\.(\w+)\.conv\.", r".ped.\1.")]
RULES = {"stgcnn": _STGCNN, "pecnet": _MLP, "lbebm": _MLP, "agentformer": _AGENTFORMER,
         "gpgraphstgcnn": _gpgraph(_STGCNN), "gpgraphsgcn": _gpgraph(_SGCN),
         "implicit": _IMPLICIT}


def _reference_keyed(baseline, seed):
    """A reference-keyed state dict of random values with the shapes of the
    port's model (the bare kernels transposed to torch's (out, in)), BN step
    counters included, and random ET keys."""
    rng = np.random.default_rng(seed)
    model = get_baseline(baseline).make_model(ExpConfig(baseline=baseline))
    sd = {}
    for name, value in model.state_dict().items():
        shape = tuple(value.shape)
        if name.endswith("_kernel"):
            shape = shape[::-1]
        if re.search(r"\.ped\.\w+\.conv\.weight$", name):
            shape = shape[:-1]                   # Conv1d (O, I, k) in the reference
        for pattern, repl in RULES[baseline]:
            name = re.sub(pattern, repl, name)
        sd[f"baseline_model.{name}"] = torch.from_numpy(
            rng.normal(size=shape).astype(np.float32))
        if name.endswith("running_var"):
            sd[f"baseline_model.{name[:-len('running_var')]}num_batches_tracked"] = \
                torch.tensor(7)
    sd.update((key, torch.from_numpy(rng.normal(size=shape).astype(np.float32)))
              for key, shape in ET_KEYS.items())
    return model, sd


@pytest.mark.parametrize("baseline", ["stgcnn", "pecnet", "lbebm", "agentformer"])
def test_the_other_converters_are_bitwise_the_jax_converters(baseline):
    model, sd = _reference_keyed(baseline, seed=len(baseline))
    got = import_state_dict(baseline, sd)
    _assert_bitwise(got, _jax_path(baseline, sd))
    missing, unexpected = model.load_state_dict(got[0], strict=False)
    unused = getattr(model, "unused_prefixes", lambda: ())()
    assert not unexpected and all(k.startswith(unused) for k in missing)
    assert (baseline == "stgcnn") == bool(missing)   # the fifth tpcnn is never called


@pytest.mark.parametrize("baseline", ["gpgraphstgcnn", "gpgraphsgcn", "implicit"])
def test_the_group_and_zone_converters_are_bitwise_the_jax_converters(baseline):
    """GP-Graph's wrapper (`group_gen.th`, `group_gen.group_cnn.0`,
    `group_mix.st_gcns_mix.{0,1}`, the baseline under `baseline_model.`,
    its BN statistics included) and Implicit's cells (bare `noise_w`,
    `global_w`, `local_w`; the per-pedestrian Conv1d weights (O, I, k) as
    (O, I, k, 1) kernels): bit for bit what the JAX converters give, and
    every parameter the model calls filled."""
    model, sd = _reference_keyed(baseline, seed=len(baseline))
    if baseline == "gpgraphsgcn":
        assert sd["baseline_model.baseline_model.sparse_weighted_adjacency_matrices."
                  "temporal_attention.embedding.weight"].shape == (64, 2)
    got = import_state_dict(baseline, sd)
    _assert_bitwise(got, _jax_path(baseline, sd))
    missing, unexpected = model.load_state_dict(got[0], strict=False)
    unused = getattr(model, "unused_prefixes", lambda: ())()
    assert not unexpected and all(k.startswith(unused) for k in missing)
    assert (baseline == "gpgraphstgcnn") == bool(missing)  # the baseline's fifth tpcnn


def test_an_unknown_baseline_names_the_converters():
    with pytest.raises(NotImplementedError, match="agentformer"):
        import_state_dict("no_such_model", {})
    assert sorted(interop.CONVERTERS) == ["agentformer", "dmrgcn", "gpgraphsgcn",
                                          "gpgraphstgcnn", "graphtern", "implicit", "lbebm",
                                          "pecnet", "sgcn", "stgcnn"]


# --- the eth snapshots of ET-DMRGCN and ET-Graph-TERN
def eth_sd(baseline):
    path = os.path.join(REPO, "benchmarks", "ref_resume", f"{baseline}-eth.pt")
    blob = torch.load(path, map_location="cpu", weights_only=False)["best_model"]
    return torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)


def eth_cfg(baseline):
    return os.path.join(REPO, "configs", f"eigentrajectory-{baseline}-eth.json")


@pytest.mark.parametrize("baseline,n_params", [("dmrgcn", 14156), ("graphtern", 17939)])
def test_the_eth_snapshots_import_bitwise_as_the_jax_package_imports_them(baseline, n_params):
    sd = eth_sd(baseline)
    assert len(sd) == 54
    got = import_state_dict(baseline, sd)
    _assert_bitwise(got, _jax_path(baseline, sd))
    model = get_baseline(baseline).make_model(ExpConfig(baseline=baseline))
    model.load_state_dict(got[0])                    # strict: every parameter filled
    assert sum(v.numel() for v in got[0].values()) == n_params
    np.testing.assert_array_equal(got[1].basis_s.U_pred.numpy(),
                                  sd["ET_s_descriptor.U_pred_trunc"].numpy())


@pytest.mark.parametrize("baseline", ["dmrgcn", "graphtern"])
def test_params_to_jax_gives_back_the_jax_init_tree(baseline):
    """The JAX model's initial tree -> params_from_jax -> the port's model
    (strict) -> params_to_jax: the same leaves, bit for bit (the PReLU
    `alpha`s, the nested `tpcn/conv`, `res_conv`, `restconv`, `rescconv`,
    `gta_0`), and no DropEdge leaf."""
    from eigentrajectory_tpu.models import get_baseline as jax_baseline
    from eigentrajectory_tpu_torch.interop import params_to_jax

    jm = jax_baseline(baseline)
    cfg = ExpConfig(baseline=baseline)
    valid = np.ones(5, bool)
    inputs = jm.prepare(jax.numpy.ones((cfg.k, 5)), jax.numpy.zeros((2, 5)),
                        {"ped_valid": jax.numpy.asarray(valid)})
    params = jm.make_model(cfg).init(jax.random.PRNGKey(3), *inputs, train=False)["params"]
    sd = eth_sd(baseline)
    et = {key: sd[key].numpy() for key in ET_KEYS}
    tree = {"params": jax.tree_util.tree_map(np.asarray, params), "batch_stats": {},
            "et": {"basis_m": {"U_obs": et["ET_m_descriptor.U_obs_trunc"],
                               "U_pred": et["ET_m_descriptor.U_pred_trunc"]},
                   "basis_s": {"U_obs": et["ET_s_descriptor.U_obs_trunc"],
                               "U_pred": et["ET_s_descriptor.U_pred_trunc"]},
                   "anchor_m": et["ET_m_anchor.C_anchor"], "anchor_s": et["ET_s_anchor.C_anchor"]}}
    state, params_et = params_from_jax(tree)
    model = get_baseline(baseline).make_model(cfg)
    model.load_state_dict(state)
    back = params_to_jax(model, params_et)

    def leaves(t, prefix=()):
        for key, value in t.items():
            if isinstance(value, dict):
                yield from leaves(value, prefix + (key,))
            else:
                yield "/".join(prefix + (key,)), value

    want, got = dict(leaves(tree["params"])), dict(leaves(back["params"]))
    assert sorted(got) == sorted(want) and back["batch_stats"] == {}
    assert not any("drop_edge" in key for key in got)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].tobytes() == value.tobytes(), key


# ------------------------------------------------- evaluation and the CLI
def _splits():
    data = make_synthetic_data(n_scenes=12, max_peds=5, seed=6)
    return data, data, data


def test_the_imported_sgcn_evaluates_as_the_jax_package(reference_sd):
    splits = _splits()
    jtr = ETJaxTrainer(jax_load_config(ZARA1_CFG), tag="imported", test_mode=True,
                       datasets=splits)
    jtr.params, jtr.batch_stats, jtr.et = jinterop.import_state_dict("sgcn", reference_sd)
    ttr = ETTorchTrainer(load_config(ZARA1_CFG), tag="imported", datasets=splits,
                         device="cpu")
    ttr.load_state(*import_state_dict("sgcn", reference_sd))
    want, got = jtr.test(eval_batch=16), ttr.test(eval_batch=16)
    for key in ("ADE", "FDE", "COL"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    assert abs(got["TCC"] - want["TCC"]) < 1e-3 and 0.0 < got["ADE"] < got["FDE"]


@pytest.mark.parametrize("baseline", ["dmrgcn", "graphtern"])
def test_the_imported_eth_models_evaluate_as_the_jax_package(baseline):
    sd = eth_sd(baseline)
    splits = _splits()
    jtr = ETJaxTrainer(jax_load_config(eth_cfg(baseline)), tag="imported", test_mode=True,
                       datasets=splits)
    jtr.params, jtr.batch_stats, jtr.et = jinterop.import_state_dict(baseline, sd)
    ttr = ETTorchTrainer(load_config(eth_cfg(baseline)), tag="imported", datasets=splits,
                         device="cpu")
    ttr.load_state(*import_state_dict(baseline, sd))
    want, got = jtr.test(eval_batch=16), ttr.test(eval_batch=16)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    assert 0.0 < got["ADE"] < got["FDE"]


def test_the_cli_writes_a_checkpoint_the_trainer_reads(tmp_path, capsys):
    from tests.test_torch_train import _write_split

    rng = np.random.default_rng(2)
    for split in ("train", "val", "test"):
        _write_split(str(tmp_path / "data" / "toy" / split), rng)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset_dir": str(tmp_path / "data"), "checkpoint_dir": str(tmp_path / "ckpt"),
        "dataset": "toy", "baseline": "sgcn", "k": 6, "num_samples": 20}))
    pth = tmp_path / "model_best.pth"
    pth.write_bytes(best_model_bytes())
    results = interop.main(["--cfg", str(cfg), "--pth", str(pth), "--tag", "imported",
                            "--device", "cpu", "--test"])
    out = capsys.readouterr().out
    assert "imported " in out and "Scene: toy ADE: " in out
    assert sorted(os.listdir(tmp_path / "ckpt" / "imported" / "toy")) == \
        ["log.pkl", "model_best.msgpack"]
    tr = ETTorchTrainer(load_config(str(cfg)), tag="imported", device="cpu")
    tr.load_model()
    assert tr.test() == results
    np.testing.assert_array_equal(tr.et.anchor_s.numpy(),
                                  torch.load(io.BytesIO(best_model_bytes()), weights_only=True)
                                  ["ET_s_anchor.C_anchor"].numpy())


@pytest.mark.parametrize("baseline", ["dmrgcn", "graphtern"])
def test_the_cli_imports_the_eth_snapshots(tmp_path, capsys, baseline):
    from tests.test_torch_train import _write_split

    rng = np.random.default_rng(3)
    for split in ("train", "val", "test"):
        _write_split(str(tmp_path / "data" / "toy" / split), rng)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset_dir": str(tmp_path / "data"), "checkpoint_dir": str(tmp_path / "ckpt"),
        "dataset": "toy", "baseline": baseline, "k": 6, "num_samples": 20}))
    pth = tmp_path / "model_best.pth"
    path = os.path.join(REPO, "benchmarks", "ref_resume", f"{baseline}-eth.pt")
    pth.write_bytes(torch.load(path, map_location="cpu", weights_only=False)["best_model"])
    results = interop.main(["--cfg", str(cfg), "--pth", str(pth), "--tag", "imported",
                            "--device", "cpu", "--test"])
    assert "Scene: toy ADE: " in capsys.readouterr().out
    tr = ETTorchTrainer(load_config(str(cfg)), tag="imported", device="cpu")
    tr.load_model()
    assert tr.test() == results
    state, _ = import_state_dict(baseline, eth_sd(baseline))
    for name, value in tr.model.state_dict().items():
        assert torch.equal(value, state[name]), name
