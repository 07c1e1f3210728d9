"""Shared helpers of the detector-family tests (``test_torch_families*``):
seeded variables of a JAX module's tree, BN statistics calibrated to a
batch, and the layout changes between the two packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.utils.torch_port import torch_state_dict_to_flax
from db_text_minimal_tpu_torch.models import DBTextModel
from db_text_minimal_tpu_torch.weights import state_dict_from_jax

ATOL = 5e-5    # the repo's fp32 model parity tolerance
SIZE, BATCH, LR = 64, 2, 0.005
HIGHEST = "highest"
FAMILIES = [("deformable_resnet18", "FPN"), ("resnet18", "FPEM_FFM")]


def np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def random_variables(module, *args, seed: int = 1,
                     offset_scale: float = 0.02):
    """Seeded numpy (params, batch_stats) of the tree that ``module.init``
    gives (``jax.eval_shape``, no init run): kernels Kaiming-normal by
    fan-out, biases, BN shifts 0.05·|noise|, BN scales 1 + 0.05·|noise|,
    means 0 and variances 1. A deformable conv's offset branch (zero at
    init) gets kernel noise × ``offset_scale`` and bias noise × 5 ×
    ``offset_scale``, so that its taps sample off the grid."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        shape, name = leaf.shape, names[-1]
        noise = rs.randn(*shape)
        if "offset_conv" in names:
            a = noise * offset_scale * (5 if name == "bias" else 1)
        elif name == "kernel":
            a = noise * np.sqrt(2.0 / (np.prod(shape[:-2]) * shape[-1]))
        elif name == "scale":
            a = 1 + np.abs(noise) * 0.05
        elif name == "bias":
            a = np.abs(noise) * 0.05
        elif name == "mean":
            a = np.zeros(shape)
        else:   # var
            a = np.ones(shape)
        return a.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v.get("batch_stats", {})


def calibrate(module: nn.Module, *inputs) -> None:
    """Set every BN's running mean to the mean of the batch ``inputs`` and
    its running variance to the batch's (biased) variance plus 1, by one
    train-mode pass at momentum 1; ``module`` is left in eval mode.

    With the init's statistics a random deep network's activations grow
    (c5 of resnet50 reaches ~55 on 64² noise), and f32 noise grows with
    them past any fixed atol; with the batch's alone a channel of 8 nearly
    equal values (c5 at 64², batch 2) divides its noise by a near-zero
    spread. Calibrated, the activations stay of order 1, as in a trained
    network."""
    bns = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    module.train()
    with torch.no_grad():
        module(*inputs)
    for m in bns:
        m.momentum = 0.1
        m.running_var += 1.0
    module.eval()


def jax_stats(module: nn.Module, prefix: str, *path: str):
    """The flax ``batch_stats`` of a port module's state_dict (the JAX
    package's own carrier, ``torch_state_dict_to_flax``) whose keys sit
    under ``prefix`` in a model (``"backbone.layer1.0"``): the subtree at
    the flax ``path`` (``"backbone", "layer1_0"``)."""
    sd = {f"{prefix}.{k}": v for k, v in module.state_dict().items()}
    _, stats = torch_state_dict_to_flax(sd, strict=True)
    for key in path:
        stats = stats[key]
    return stats


def apply(module, params, stats, x, train: bool = False):
    """The JAX module's output, jitted, at the highest matmul precision;
    in train mode without the moved statistics."""
    def run(v, x):
        if train:
            return module.apply(v, x, train=True,
                                mutable=["batch_stats"])[0]
        return module.apply(v, x)

    with jax.default_matmul_precision(HIGHEST):
        return np_tree(jax.jit(run)({"params": params, "batch_stats": stats},
                                    x))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def images(h: int = SIZE, w: int = SIZE, n: int = BATCH, seed: int = 0):
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(
        np.float32) * 2 - 1


def zeros_input(h: int = SIZE, w: int = SIZE):
    return jnp.zeros((1, h, w, 3))


@pytest.fixture(scope="module", params=FAMILIES, ids=lambda f: "+".join(f))
def family(request):
    """A family's seeded JAX variables, BN statistics calibrated to the
    batch, and the port's model on them (fp32, eval mode)."""
    backbone, neck = request.param
    x = images()
    jm = JaxDBTextModel(backbone_name=backbone, neck_name=neck)
    params, stats = random_variables(jm, zeros_input())
    model = DBTextModel(backbone_name=backbone, neck_name=neck)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    calibrate(model, torch.from_numpy(x))
    _, stats = torch_state_dict_to_flax(model.state_dict(), strict=True)
    return {"backbone": backbone, "neck": neck, "jax": jm, "x": x,
            "params": params, "stats": stats, "model": model}
