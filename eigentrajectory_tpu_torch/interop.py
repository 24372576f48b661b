"""Checkpoints in the JAX package's format, read into PyTorch and written
from it.

`read_flax_msgpack` decodes a flax `serialization.to_bytes` file with no
dependency beyond NumPy (neither flax nor the `msgpack` package), and
`params_from_jax` maps the decoded {params, batch_stats, et} tree onto the
port's module names and `ETParams`. `params_to_jax` and `write_flax_msgpack`
are their inverses: a checkpoint the port writes is one the JAX package's
`load_model` reads.

The reference's own checkpoints import too. The reference saves the state
dict of its whole EigenTrajectory module: the frozen ET parameters under
`ET_{m,s}_descriptor.*` / `ET_{m,s}_anchor.C_anchor` and the predictor under
`baseline_model.*`. `import_state_dict` maps such a state dict onto the
port's predictor and `ETParams` (the basis and anchors verbatim: the weights
were trained against exactly that pair), and `import_checkpoint_to_trainer`
writes it as a `model_best.msgpack`:

  python -m eigentrajectory_tpu_torch.interop --cfg configs/eigentrajectory-sgcn-zara1.json \
      --pth model_best.pth --tag imported [--test] [--device cpu]
"""
from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .etspace.descriptor import ETBasis
from .etspace.facade import ETParams

# flax's msgpack extension types: an ndarray, packed [shape, dtype, bytes],
# and a numpy scalar, packed the same way with shape [].
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """A minimal msgpack decoder: maps, arrays, str/bin, ints, floats, nil,
    bool, and flax's ndarray and numpy-scalar extensions."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def read(self) -> Any:
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._unpack(fixed[b])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",     # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",     # str
                 0xDC: ">H", 0xDD: ">I",                 # array
                 0xDE: ">H", 0xDF: ">I",                 # map
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}     # ext
        if b in sized:
            n = self._unpack(sized[b])
            if b <= 0xC6:
                return bytes(self._take(n))
            if 0xD9 <= b <= 0xDB:
                return str(self._take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return self._array(n)
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {self.pos - 1}")

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _ext(self, n: int):
        code = self._unpack(">b")
        data = bytes(self._take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, raw = _Reader(data).read()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """Decode a flax msgpack checkpoint into a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


def _head(n: int, fix: Tuple[int, int], sized: Tuple[Tuple[int, str], ...]) -> bytes:
    """The header of a msgpack object of length n: the one-byte form
    (base | n) up to its limit, else the smallest sized form that holds n."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for code, fmt in sized:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"object of length {n} is too long for msgpack")


def _pack(obj: Any) -> bytes:
    """msgpack bytes of a tree of dicts (str keys), lists, ndarrays, numpy
    scalars, ints, floats, str, bytes, bool and None, each in the shortest
    encoding, as the `msgpack` package chooses them, with ndarrays and numpy
    scalars in flax's extension types."""
    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        if 0 <= obj:
            return _head(obj, (0x00, 0x7F), ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                                             (0xCF, ">Q")))
        if obj >= -32:
            return struct.pack(">b", obj)
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
            if obj >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([code]) + struct.pack(fmt, obj)
        raise ValueError(f"integer {obj} is too large for msgpack")
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _head(len(raw), (0xA0, 31), ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))) + raw
    if isinstance(obj, (bytes, bytearray)):
        return _head(len(obj), None, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return _head(len(obj), (0x90, 15), ((0xDC, ">H"), (0xDD, ">I"))) + \
            b"".join(_pack(x) for x in obj)
    if isinstance(obj, dict):
        return _head(len(obj), (0x80, 15), ((0xDE, ">H"), (0xDF, ">I"))) + \
            b"".join(_pack(str(k)) + _pack(v) for k, v in obj.items())
    if isinstance(obj, (np.ndarray, np.generic)):
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        arr = np.asarray(obj)
        if arr.dtype.hasobject:
            raise ValueError("object arrays cannot be written")
        data = _pack((list(arr.shape), arr.dtype.name, arr.tobytes("C")))
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixext:
            head = bytes([fixext[len(data)]])
        else:
            head = _head(len(data), None, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
        return head + struct.pack(">b", code) + data
    raise TypeError(f"cannot write a {type(obj).__name__} to msgpack")


def write_flax_msgpack(path: str, tree: Dict[str, Any]) -> None:
    """Write a nested dict of numpy arrays as flax's `serialization.to_bytes`
    writes a state dict (the inverse of `read_flax_msgpack`). Every object
    gets the encoding flax gives it; the keys go out in the tree's own order
    (flax reads any order)."""
    data = _pack(tree)
    with open(path, "wb") as f:
        f.write(data)


# Leaf names of the JAX layers -> the port's parameter and buffer names. Any
# other leaf is a parameter of the JAX module itself, outside any layer (a
# bare kernel or bias): it keeps its name and its (in, out) layout on both
# sides.
_PARAM_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight", "alpha": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Dict, names: Dict[str, str], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, names, prefix + (key,))
        else:
            if key == "kernel" and np.ndim(value) == 2:
                value = np.asarray(value).T      # linear (in, out) -> (out, in)
            yield ".".join(prefix + (names.get(key, key),)), value


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def module_state_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a JAX module's {params[, batch_stats]} tree onto the port's names:
    a state dict for the port's module (conv `kernel` (already OIHW) ->
    `weight`, linear `kernel` (in, out) -> `weight` (out, in), transposed,
    BatchNorm and LayerNorm `scale` -> `weight`, PReLU `alpha` -> `weight`,
    the bare kernels and biases by their own names, untransposed,
    batch_stats `mean`/`var` -> `running_mean`/`running_var`), as CPU
    tensors of the tree's types."""
    state = {name: _tensor(value) for name, value in
             _flatten(variables["params"], _PARAM_NAMES)}
    state.update((name, _tensor(value)) for name, value in
                 _flatten(variables.get("batch_stats", {}), _STAT_NAMES))
    return state


def params_from_jax(tree: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor], ETParams]:
    """Map a decoded {params, batch_stats, et} checkpoint tree onto the
    port: the predictor's state dict (`module_state_from_jax`) and the
    ETParams, all as CPU float tensors."""
    t = _tensor
    state = module_state_from_jax(tree)
    et = tree["et"]
    params = ETParams(
        basis_m=ETBasis(t(et["basis_m"]["U_obs"]), t(et["basis_m"]["U_pred"])),
        basis_s=ETBasis(t(et["basis_s"]["U_obs"]), t(et["basis_s"]["U_pred"])),
        anchor_m=t(et["anchor_m"]), anchor_s=t(et["anchor_s"]))
    return state, params


def jax_param_paths(model: nn.Module) -> Dict[str, str]:
    """The JAX package's path ("st_gcn_0/res_bn/scale") of every parameter
    and statistic of `model`, by the port's name ("st_gcn_0.res_bn.weight").
    The layers that are built and never called have no counterpart and are
    left out."""
    unused = getattr(model, "unused_prefixes", lambda: ())()
    paths = {}
    for prefix, module in model.named_modules():
        own = dict(module.named_parameters(recurse=False))
        own.update(module.named_buffers(recurse=False))
        for name in own:
            full = f"{prefix}.{name}" if prefix else name
            if full.startswith(unused):
                continue
            if name == "weight":
                leaf = "kernel" if isinstance(module, (nn.Conv2d, nn.Linear)) else \
                    "scale" if "running_mean" in own or isinstance(module, nn.LayerNorm) \
                    else "alpha"
            else:                                # a bare parameter keeps its name
                leaf = {"running_mean": "mean", "running_var": "var"}.get(name, name)
            paths[full] = "/".join(prefix.split(".") + [leaf] if prefix else [leaf])
    return paths


def params_to_jax(model: nn.Module, et: ETParams) -> Dict[str, Any]:
    """The {params, batch_stats, et} tree of the JAX package's checkpoint from
    the port's predictor and ET parameters (the inverse of `params_from_jax`),
    as float32 numpy arrays: linear weights transposed back to (in, out),
    keys sorted at every level as the JAX trainer's trees are, the ET
    parameters in their field order."""
    def arr(x):
        return np.ascontiguousarray(x.detach().cpu().numpy().astype(np.float32))

    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    linear = {f"{p}.weight" for p, m in model.named_modules() if isinstance(m, nn.Linear)}
    for name, path in sorted(jax_param_paths(model).items(), key=lambda kv: kv[1]):
        *parents, leaf = path.split("/")
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for key in parents:
            node = node.setdefault(key, {})
        value = arr(tensors[name])
        node[leaf] = np.ascontiguousarray(value.T) if name in linear else value
    tree["et"] = {
        "basis_m": {"U_obs": arr(et.basis_m.U_obs), "U_pred": arr(et.basis_m.U_pred)},
        "basis_s": {"U_obs": arr(et.basis_s.U_obs), "U_pred": arr(et.basis_s.U_pred)},
        "anchor_m": arr(et.anchor_m), "anchor_s": arr(et.anchor_s)}
    return tree


# ---------------------------------------------------------------------------
# Reference checkpoints: a state dict of the reference's EigenTrajectory
# module -> the port's predictor state dict and ETParams
# ---------------------------------------------------------------------------

def _module(sd: Dict[str, np.ndarray], ours: str, theirs: str) -> Dict[str, np.ndarray]:
    """The leaves of the reference's module `theirs` (weight, bias, running
    statistics: the names are torch's on both sides) under our module name
    `ours`; BatchNorm's step counter has no counterpart."""
    pre = f"{theirs}."
    out = {f"{ours}.{key[len(pre):]}": value for key, value in sd.items()
           if key.startswith(pre) and "." not in key[len(pre):]
           and not key.endswith("num_batches_tracked")}
    if not out:
        raise KeyError(f"the reference checkpoint has no module {theirs}")
    return out


def _modules(sd, pairs) -> Dict[str, np.ndarray]:
    out = {}
    for ours, theirs in pairs:
        out.update(_module(sd, ours, theirs))
    return out


def _import_stgcnn(sd):
    """social_stgcnn -> `models/stgcnn.py`. The reference builds a fifth
    tpcnn and PReLU that it never calls; the port leaves them out."""
    g = "st_gcns.0"
    pairs = [("st_gcn_0.gcn_conv", f"{g}.gcn.conv"), ("st_gcn_0.tcn_bn1", f"{g}.tcn.0"),
             ("st_gcn_0.tcn_prelu", f"{g}.tcn.1"), ("st_gcn_0.tcn_conv", f"{g}.tcn.2"),
             ("st_gcn_0.tcn_bn2", f"{g}.tcn.3"), ("st_gcn_0.res_conv", f"{g}.residual.0"),
             ("st_gcn_0.res_bn", f"{g}.residual.1"), ("st_gcn_0.out_prelu", f"{g}.prelu"),
             ("tpcnn_output", "tpcnn_ouput")]
    for i in range(4):
        pairs += [(f"tpcnn_{i}", f"tpcnns.{i}"), (f"prelu_{i}", f"prelus.{i}")]
    return _modules(sd, pairs)


def _import_sgcn(sd):
    """TrajectoryModel (SGCN) -> `models/sgcn.py`."""
    swa, ours = "sparse_weighted_adjacency_matrices", "sparse_adjacency"
    pairs = [(f"{ours}.spa_fusion_conv", f"{swa}.spa_fusion.conv.0"),
             (f"{ours}.spa_fusion_prelu", f"{swa}.spa_fusion.conv.1")]
    for attn in ("spatial_attention", "temporal_attention"):
        pairs += [(f"{ours}.{attn}.{name}", f"{swa}.{attn}.{name}")
                  for name in ("embedding", "query", "key")]
    for stream in ("spatial", "temporal"):
        for j in range(7):
            base = f"{swa}.interaction_mask.{stream}_asymmetric_convolutions.{j}"
            pairs += [(f"{ours}.interaction_mask.{stream}_{j}.{name}", f"{base}.{name}")
                      for name in ("conv1", "conv2", "activation")]
    for mine, theirs in (("st_gcn", "spatial_temporal_sparse_gcn"),
                         ("ts_gcn", "temporal_spatial_sparse_gcn")):
        for i in range(2):
            pairs += [(f"stsgcn.{mine}_{i}.{name}", f"stsgcn.{theirs}.{i}.{name}")
                      for name in ("embedding", "activation")]
    pairs += [("fusion", "fusion_"), ("output", "output")]
    for j in range(5):
        pairs += [(f"tcn_{j}", f"tcns.{j}.0"), (f"tcn_prelu_{j}", f"tcns.{j}.1")]
    return _modules(sd, pairs)


def _import_dmrgcn(sd):
    """social_dmrgcn -> `models/dmrgcn.py`."""
    g = "st_dmrgcns.0"
    pairs = [("st_dmrgcn_0.tcn_prelu", f"{g}.tcn.0"), ("st_dmrgcn_0.tcn_conv", f"{g}.tcn.1"),
             ("st_dmrgcn_0.res_conv", f"{g}.residual.0"), ("st_dmrgcn_0.out_prelu", f"{g}.prelu")]
    pairs += [(f"st_dmrgcn_0.gcn_{r}.conv", f"{g}.gcns.{r}.conv") for r in range(2)]
    for i in range(4):
        pairs += [(f"tpcnn_{i}.gta_0", f"tpcnns.{i}.gtacn.0.0"),
                  (f"tpcnn_{i}.gta_prelu_0", f"tpcnns.{i}.gtacn.0.1")]
        for j in range(2):
            pairs += [(f"tpcnn_{i}.tpcn_{j}", f"tpcnns.{i}.tpcn.{j}.0"),
                      (f"tpcnn_{i}.tpcn_prelu_{j}", f"tpcnns.{i}.tpcn.{j}.1")]
    pairs.append(("tpcnn_0.res_conv", "tpcnns.0.residual.0"))
    return _modules(sd, pairs)


def _import_graphtern(sd):
    """graph_tern_light -> `models/graphtern.py`. The reference's st_mrgcn
    builds an output PReLU (`tp_mrgcns.0.prelu`) that it skips with
    use_mdn=True; the port leaves it out."""
    g = "tp_mrgcns.0"
    pairs = [("tp_mrgcn_0.gcn.conv", f"{g}.gcn.conv"), ("tp_mrgcn_0.tcn_prelu", f"{g}.tcn.0"),
             ("tp_mrgcn_0.tcn_conv", f"{g}.tcn.1"), ("tp_mrgcn_0.res_conv", f"{g}.residual.0")]
    for k in range(6):
        pairs += [(f"epcnn_{k}.tpcn.conv", f"tpcnns.{k}.tpcns.0.0"),
                  (f"epcnn_{k}.tpcn_prelu", f"tpcnns.{k}.tpcns.0.1"),
                  (f"epcnn_{k}.cpcn.conv", f"tpcnns.{k}.cpcns.0.0"),
                  (f"epcnn_{k}.cpcn_prelu", f"tpcnns.{k}.cpcns.0.1")]
    # At the ET widths only block 0 changes the time axis (8 -> 6) and only
    # block 5 the channels (16 -> 20).
    pairs += [("epcnn_0.restconv", "tpcnns.0.restconv.0"),
              ("epcnn_5.rescconv", "tpcnns.5.rescconv.0")]
    return _modules(sd, pairs)


def _import_mlps(sd, names) -> Dict[str, np.ndarray]:
    """PECNet-style MLPs: the reference's `<mlp>.layers.<i>` -> our
    `<mlp>.layer_<i>`, for every layer the checkpoint holds."""
    pairs = []
    for name in names:
        i = 0
        while f"{name}.layers.{i}.weight" in sd:
            pairs.append((f"{name}.layer_{i}", f"{name}.layers.{i}"))
            i += 1
        if not i:
            raise KeyError(f"the reference checkpoint has no MLP layers under {name}")
    return _modules(sd, pairs)


def _import_pecnet(sd):
    """PECNet's predict path -> `models/pecnet.py`."""
    return _import_mlps(sd, ("encoder_past", "encoder_dest", "non_local_theta",
                             "non_local_phi", "non_local_g", "predictor"))


def _import_lbebm(sd):
    """LB-EBM's predict path -> `models/lbebm.py`."""
    return _import_mlps(sd, ("encoder_past", "encoder_dest", "predictor"))


def _import_agentformer(sd):
    """AgentFormer (the ET wiring) -> `models/agentformer.py`. The fused
    in-projections of self-attention become `in_proj` / `in_proj_self`
    linears; those of cross-attention and `out_fc` become the bare kernels
    of the JAX layout (in, out), transposed."""
    pairs = [("ctx_input_fc", "context_encoder.input_fc"),
             ("ctx_pos_encoder.fc", "context_encoder.pos_encoder.fc"),
             ("dec_input_fc", "future_decoder.input_fc"),
             ("dec_pos_encoder.fc", "future_decoder.pos_encoder.fc")]
    out = {"out_fc_kernel": sd["future_decoder.out_fc.weight"].T,
           "out_fc_bias": sd["future_decoder.out_fc.bias"]}

    def attention(ours, theirs, cross):
        pairs.append((f"{ours}.out_proj", f"{theirs}.out_proj"))
        if cross:
            out.update({f"{ours}.in_proj_kernel": sd[f"{theirs}.in_proj_weight"].T,
                        f"{ours}.in_proj_bias": sd[f"{theirs}.in_proj_bias"],
                        f"{ours}.in_proj_self_kernel": sd[f"{theirs}.in_proj_weight_self"].T,
                        f"{ours}.in_proj_self_bias": sd[f"{theirs}.in_proj_bias_self"]})
        else:
            out.update({f"{ours}.in_proj.weight": sd[f"{theirs}.in_proj_weight"],
                        f"{ours}.in_proj.bias": sd[f"{theirs}.in_proj_bias"],
                        f"{ours}.in_proj_self.weight": sd[f"{theirs}.in_proj_weight_self"],
                        f"{ours}.in_proj_self.bias": sd[f"{theirs}.in_proj_bias_self"]})

    for kind, base, norms in (("enc", "context_encoder.tf_encoder", 2),
                              ("dec", "future_decoder.tf_decoder", 3)):
        for i in range(2):
            ours, theirs = f"{kind}_layer_{i}", f"{base}.layers.{i}"
            attention(f"{ours}.self_attn", f"{theirs}.self_attn", cross=False)
            if kind == "dec":
                attention(f"{ours}.multihead_attn", f"{theirs}.multihead_attn", cross=True)
            pairs += [(f"{ours}.{name}", f"{theirs}.{name}")
                      for name in ("linear1", "linear2", *(f"norm{j}" for j in range(1, norms + 1)))]
    out.update(_modules(sd, pairs))
    return out


def _import_implicit(sd):
    """SocialImplicitLight -> `models/implicit.py`. The per-pedestrian
    Conv1d weights (O, I, k) become the (O, I, k, 1) kernels of the port's
    `Conv1dTorch`, under `.conv`."""
    out = {}
    for i in range(4):
        ours, theirs = f"cell_{i}", f"implicit_cells.{i}"
        for name in ("noise_w", "global_w", "local_w"):
            out[f"{ours}.{name}"] = sd[f"{theirs}.{name}"]
        out.update(_modules(sd, [(f"{ours}.{name}", f"{theirs}.{name}")
                                 for name in ("feat", "highway_input", "highway", "tpcnn")]))
        for name in ("feat", "highway_input", "highway", "tpcnn"):
            out[f"{ours}.ped.{name}.conv.weight"] = sd[f"{theirs}.ped.{name}.weight"][..., None]
            out[f"{ours}.ped.{name}.conv.bias"] = sd[f"{theirs}.ped.{name}.bias"]
    return out


def _import_gpgraph(sd, baseline_converter):
    """The GPGraph wrapper: the weight-shared baseline under
    `baseline_model.`, GroupGenerator (learned_l2norm) and GroupIntegrator
    (mlp)."""
    inner = {k[len("baseline_model."):]: v for k, v in sd.items()
             if k.startswith("baseline_model.")}
    out = {f"baseline_model.{k}": v for k, v in baseline_converter(inner).items()}
    out["group_gen.th"] = sd["group_gen.th"]
    out.update(_modules(sd, [("group_gen.group_cnn", "group_gen.group_cnn.0"),
                             ("group_mix.mix_prelu", "group_mix.st_gcns_mix.0"),
                             ("group_mix.mix_conv", "group_mix.st_gcns_mix.1")]))
    return out


CONVERTERS: Dict[str, Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]] = {
    "stgcnn": _import_stgcnn,
    "sgcn": _import_sgcn,
    "dmrgcn": _import_dmrgcn,
    "graphtern": _import_graphtern,
    "gpgraphstgcnn": lambda sd: _import_gpgraph(sd, _import_stgcnn),
    "gpgraphsgcn": lambda sd: _import_gpgraph(sd, _import_sgcn),
    "implicit": _import_implicit,
    "pecnet": _import_pecnet,
    "lbebm": _import_lbebm,
    "agentformer": _import_agentformer,
}


def import_et_params(sd: Dict[str, Any]) -> ETParams:
    """The reference's `ET_{m,s}_descriptor` bases and `ET_{m,s}_anchor`
    anchors as ETParams of CPU tensors, verbatim."""
    def t(key):
        return torch.from_numpy(np.array(sd[key]))

    def basis(tag):
        return ETBasis(U_obs=t(f"ET_{tag}_descriptor.U_obs_trunc"),
                       U_pred=t(f"ET_{tag}_descriptor.U_pred_trunc"))

    return ETParams(basis_m=basis("m"), basis_s=basis("s"),
                    anchor_m=t("ET_m_anchor.C_anchor"), anchor_s=t("ET_s_anchor.C_anchor"))


def import_state_dict(baseline: str, state_dict: Dict[str, Any]
                      ) -> Tuple[Dict[str, torch.Tensor], ETParams]:
    """A reference EigenTrajectory state dict (tensors or arrays) -> (the
    port's predictor state dict for `baseline`, ETParams), CPU tensors."""
    if baseline not in CONVERTERS:
        raise NotImplementedError(
            f"no reference-checkpoint converter for '{baseline}' yet; "
            f"available: {sorted(CONVERTERS)}")
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in state_dict.items()}
    pred_sd = {k[len("baseline_model."):]: v for k, v in sd.items()
               if k.startswith("baseline_model.")}
    state = {name: torch.from_numpy(np.array(value))
             for name, value in CONVERTERS[baseline](pred_sd).items()}
    return state, import_et_params(sd)


def import_checkpoint_to_trainer(cfg, pth_path: str, tag: str, device: str = "cuda",
                                 unsafe: bool = False, datasets=None):
    """Read a reference `.pth`, convert it, load it into a trainer of `cfg`
    on `device` and write it as `<checkpoint_dir>/<tag>/<dataset>/
    model_best.msgpack`; returns the trainer. `datasets` as for
    `ETTorchTrainer`.

    A state dict is plain tensors, so torch's restricted unpickler reads it;
    `unsafe=True` (CLI `--unsafe`) allows full unpickling of a file the
    caller trusts."""
    from .train.trainer import ETTorchTrainer

    state_dict = torch.load(pth_path, map_location="cpu", weights_only=not unsafe)
    state, et = import_state_dict(cfg.baseline, state_dict)
    tr = ETTorchTrainer(cfg, tag=tag, datasets=datasets, device=device)
    tr.load_state(state, et)
    tr.save_model()
    return tr


def main(argv=None):
    import argparse

    from .config import load_config

    ap = argparse.ArgumentParser(description="Import a reference checkpoint (.pth).")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--pth", required=True)
    ap.add_argument("--tag", default="imported")
    ap.add_argument("--test", action="store_true", help="evaluate after importing")
    ap.add_argument("--unsafe", action="store_true",
                    help="allow full (arbitrary-code) unpickling of the .pth")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    cfg = load_config(args.cfg)
    tr = import_checkpoint_to_trainer(cfg, args.pth, args.tag, device=args.device,
                                      unsafe=args.unsafe)
    print(f"imported {args.pth} -> {tr.checkpoint_dir}", flush=True)
    if args.test:
        results = tr.test()
        print(f"Scene: {cfg.dataset}", *[f"{k}: {v:.8f}" for k, v in results.items()],
              flush=True)
        return results
    return None


if __name__ == "__main__":
    main()
