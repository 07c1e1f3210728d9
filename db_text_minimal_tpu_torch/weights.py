"""Weights between the JAX package's Flax pytrees and PyTorch state_dicts.

``state_dict_from_jax`` is the inverse of the JAX package's
``utils/torch_port.torch_state_dict_to_flax``: it takes the ``params`` and
``batch_stats`` pytrees (numpy leaves) of a ``DBTextModel`` and returns a
state_dict with the reference's key names, so a ``.pth`` saved from it loads
into both packages. Layouts:

- Conv2d kernel: Flax HWIO -> torch OIHW.
- ConvTranspose2d kernel: Flax (kh, kw, in, out) -> torch (in, out, kh, kw),
  spatially flipped back (torch's transposed conv is the conv adjoint, Flax's
  ``transpose_kernel=False`` form is a fractionally-strided conv).
- BatchNorm scale/bias -> weight/bias, mean/var -> running_mean/running_var,
  plus ``num_batches_tracked`` = 0.

Every backbone, neck and head of ``models`` converts: a Bottleneck's
``conv3``/``bn3``; a deformable conv's kernel (3, 3, C, F) into
``conv2.weight`` (F, C, 3, 3) and its ``offset_conv`` kernel and bias; the
FPEM_FFM neck's ``fpem_i.{up,down}_addK.{depthwise_conv,pointwise_conv,
bn}``, a depthwise HWIO (3, 3, 1, C) kernel into (C, 1, 3, 3), and its
``reduce_conv_cK``; ``ConvHead``'s ``conv``. Both DB head layouts convert: ``DBHead`` (``binarize``/``thresh`` branches, keys
``segmentation_head.binarize.0.weight`` ...) and ``FusedDBHead`` (keys
``segmentation_head.conv1.weight``, ``segmentation_head.binarize_deconv1``
...).

``rec_state_dict_from_jax`` does the same for a ``RecognitionModel``
(``models/recognition``): conv kernels OIHW, dense kernels (in, out) ->
(out, in), and each flax ``OptimizedLSTMCell`` into torch's packed LSTM
weights (gate order i, f, g, o in both; flax's one bias per gate goes to
``bias_hh`` and ``bias_ih`` is zero). A BiLSTM's ``OptimizedLSTMCell_0`` is
its forward direction and ``OptimizedLSTMCell_1`` its backward one
(``_reverse``).

``quant_vars_from_jax`` carries the JAX package's BN-folded and int8 tree
into the port's ``models.quant_infer`` tree, so that both packages run the
same int8 weights and static scales.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

# Flax layer name -> index in each DBHead branch's nn.Sequential
_HEAD_SEQ_INDEX = {"conv1": "0", "bn1": "1", "deconv1": "3", "bn2": "4",
                   "deconv2": "6"}
_LAYER_RE = re.compile(r"^layer(\d+)_(\d+)$")
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _module_key(path: list[str]) -> str:
    top, rest = path[0], list(path[1:])
    out: list[str] = []
    if top == "backbone":
        for name in rest:
            m = _LAYER_RE.match(name)
            if m:
                out += [f"layer{m.group(1)}", m.group(2)]
            elif name == "downsample_conv":
                out += ["downsample", "0"]
            elif name == "downsample_bn":
                out += ["downsample", "1"]
            else:
                out.append(name)
    elif top == "segmentation_body":
        out = {"conv": ["conv", "0"], "conv_bn": ["conv", "1"]}.get(
            "/".join(rest), rest)
    elif top == "segmentation_head":
        if rest[0] in ("binarize", "thresh") and len(rest) == 2:
            out = [rest[0], _HEAD_SEQ_INDEX[rest[1]]]
        else:
            out = rest
    else:
        raise ValueError(f"unknown subtree {top!r}")
    return ".".join([top] + out)


def _leaves(tree: Mapping[str, Any], path=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield list(path), key, np.asarray(value)


def _kernel(value: np.ndarray, deconv: bool) -> np.ndarray:
    if deconv:   # (kh, kw, in, out) -> (in, out, kh, kw), flip kh and kw
        return np.transpose(value, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return np.transpose(value, (3, 2, 0, 1))   # HWIO -> OIHW


def state_dict_from_jax(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any]) -> dict:
    """Flax ``params``/``batch_stats`` of a ``DBTextModel`` -> torch
    state_dict (CPU tensors) with the reference's key names."""
    sd: dict = {}
    for tree in (params, batch_stats):
        for path, leaf, value in _leaves(tree):
            module = _module_key(path)
            if leaf == "kernel":
                value = _kernel(value, deconv="deconv" in path[-1])
                name = "weight"
            else:
                name = _LEAF[leaf]
            if leaf == "scale":
                sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
            sd[f"{module}.{name}"] = torch.from_numpy(
                np.ascontiguousarray(value).copy())
    return sd


_REC_RENAMES = (
    # localization conv{i}/bn{i} -> blocks.{i}.conv/bn
    (re.compile(r"^(transformation/localization)/(conv|bn)(\d)/"),
     r"\1/blocks/\3/\2/"),
    # GRCL bn_gf_{it} -> bn_gf.{it}
    (re.compile(r"/(bn_(?:gf|gr|x|h))_(\d+)/"), r"/\1/\2/"),
    # residual blocks b3_{i} -> b3.{i}
    (re.compile(r"/(b\d)_(\d+)/"), r"/\1/\2/"),
    # _conv_bn_relu's {name}_conv / {name}_bn -> {name}.conv / {name}.bn
    (re.compile(r"/(\w+?)_(conv|bn)/"), r"/\1/\2/"),
)
_LSTM_RE = re.compile(r"^(.*)/(OptimizedLSTMCell_([01])|rnn)/(\w\w)/(\w+)$")


def _rec_key(path: str) -> str:
    for pattern, repl in _REC_RENAMES:
        path = pattern.sub(repl, path)
    return path.replace("/", ".")


def rec_state_dict_from_jax(params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any]) -> dict:
    """Flax ``params``/``batch_stats`` of a ``RecognitionModel`` -> torch
    state_dict (CPU tensors) of the port's ``RecognitionModel``."""
    sd: dict = {}
    cells: dict = {}
    for tree in (params, batch_stats):
        for path, leaf, value in _leaves(tree):
            full = "/".join(path + [leaf])
            m = _LSTM_RE.match(full)
            if m:
                prefix, cell, direction, gate, kind = m.groups()
                if cell == "rnn":     # the decoder's nn.LSTMCell
                    key = (f"{prefix}/rnn", "")
                else:                 # a BiLSTM's nn.LSTM
                    key = (f"{prefix}/rnn",
                           "_l0_reverse" if direction == "1" else "_l0")
                cells.setdefault(key, {})[(gate, kind)] = value
                continue
            module = _rec_key("/".join(path) + "/")
            if leaf == "kernel":
                value = (np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4
                         else value.T)
                name = "weight"
            else:
                name = _LEAF[leaf]
            if leaf == "scale":
                sd[f"{module}num_batches_tracked"] = torch.tensor(0)
            sd[f"{module}{name}"] = value
    for (module, suffix), gates in cells.items():
        module = _rec_key(module + "/")
        order = "ifgo"
        sd[f"{module}weight_ih{suffix}"] = np.concatenate(
            [gates[("i" + g, "kernel")] for g in order], axis=1).T
        sd[f"{module}weight_hh{suffix}"] = np.concatenate(
            [gates[("h" + g, "kernel")] for g in order], axis=1).T
        bias = np.concatenate([gates[("h" + g, "bias")] for g in order])
        sd[f"{module}bias_hh{suffix}"] = bias
        sd[f"{module}bias_ih{suffix}"] = np.zeros_like(bias)
    return {k: v if isinstance(v, torch.Tensor) else
            torch.from_numpy(np.ascontiguousarray(v).copy())
            for k, v in sd.items()}


def quant_vars_from_jax(qvars: Mapping[str, Any]) -> dict:
    """The JAX package's folded (and quantized) tree from
    ``quant_infer.prepare_quant_params`` (numpy leaves, HWIO kernels) ->
    the port's ``models.quant_infer`` tree (CPU tensors): float conv
    kernels OIHW, int8 conv kernels OHWI (int8 stays int8), deconv kernels
    as ``_kernel`` lays them out; ``bias``, ``eff_scale`` and ``act_scale``
    as f32 tensors."""

    def node(name: str, leaves: Mapping[str, Any]) -> dict:
        out = {}
        for key, value in leaves.items():
            value = np.asarray(value)
            if key == "kernel":
                if value.dtype == np.int8:
                    value = np.transpose(value, (3, 0, 1, 2))   # OHWI
                else:
                    value = _kernel(value, deconv="deconv" in name)
            else:
                value = value.astype(np.float32)
            out[key] = torch.from_numpy(np.ascontiguousarray(value).copy())
        return out

    def walk(tree: Mapping[str, Any], name: str = "") -> dict:
        if "kernel" in tree:
            return node(name, tree)
        return {k: walk(v, k) for k, v in tree.items()}

    return walk(qvars)
