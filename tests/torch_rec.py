"""Shared helpers of the recognizer tests: the same Flax variables in the
JAX package's ``RecognitionModel`` and, through
``weights.rec_state_dict_from_jax``, in the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from db_text_minimal_tpu.models.recognition import \
    RecognitionModel as JaxRecognitionModel
from db_text_minimal_tpu.models.recognition import _base_fiducials
from db_text_minimal_tpu_torch.models.recognition import RecognitionModel
from db_text_minimal_tpu_torch.weights import rec_state_dict_from_jax

CHARSET = "0123456789abcdefghijklmnopqrstuvwxyz"
ATOL = 5e-5   # the repo's model parity tolerance (tests/test_models.py)
# small widths: every stage at a few channels, decode of 6 steps
SMALL = {"hidden_size": 16, "output_channel": 32, "batch_max_length": 5}


def random_variables(model, *args, seed: int = 0, **kwargs):
    """Seeded numpy variables of the tree shape that ``model.init`` gives
    (``jax.eval_shape``, no init run): kernels at lecun scale, biases and BN
    shifts and means near 0, BN scales and variances near 1; the TPS
    localization's fc2 near the identity fiducials."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *args, **kwargs))
    rs = np.random.RandomState(seed)
    fiducials = _base_fiducials(20).reshape(-1)

    def fill(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        shape, name = leaf.shape, names[-1]
        noise = rs.randn(*shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = noise / np.sqrt(fan_in)
            if "fc2" in names:
                a = noise * 0.05
        elif name in ("scale", "var"):
            a = 1 + np.abs(noise) * 0.1
        elif "fc2" in names:
            a = fiducials[:shape[0]] + noise * 0.02
        else:
            a = noise * 0.05
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_init(model, *args, seed: int = 0, **kwargs):
    """``random_variables`` as a dict of numpy trees."""
    return dict(random_variables(model, *args, seed=seed, **kwargs))


def crops(n: int, seed: int = 0, h: int = 32, w: int = 100, c: int = 1):
    return (np.random.RandomState(seed).rand(n, h, w, c).astype(np.float32)
            * 2 - 1)


def smooth_crops(n: int, seed: int = 0, h: int = 32, w: int = 100):
    """Crops of a few long-period waves (steps under 0.02 a pixel) that fade
    to 0 at the border. The TPS grid's float32 rounding (~7e-4 pixels in
    either package, see ``test_torch_recognition``) then moves each sample,
    including those that blend with the zero padding, by less than ATOL."""
    rs = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    window = (np.sin(np.pi * (yy + 0.5) / h)
              * np.sin(np.pi * (xx + 0.5) / w))
    out = np.zeros((n, h, w, 1), np.float32)
    for i in range(n):
        for _ in range(3):
            fx, fy = rs.uniform(-1, 1, 2) * 2 * np.pi / 400
            out[i, ..., 0] += 0.3 * window * np.sin(
                fx * xx + fy * yy + rs.uniform(0, 2 * np.pi))
    return out


def rec_pair(num_class: int, seed: int = 0, **kw):
    """(JAX model, its nudged variables, the port's model carrying them in
    eval mode)."""
    jm = JaxRecognitionModel(num_class=num_class, **kw)
    v = jax_init(jm, jnp.zeros((1, 32, 100, 1)),
                 text=jnp.zeros((1, jm.batch_max_length + 2), jnp.int32),
                 train=False, seed=seed)
    pm = RecognitionModel(num_class, **kw)
    pm.load_state_dict(rec_state_dict_from_jax(v["params"],
                                               v.get("batch_stats", {})),
                       strict=True)
    return jm, v, pm.eval()


def jax_apply(model, variables, x, **kwargs):
    """``model.apply`` jitted (eager flax runs op by op, ~5x slower here),
    at the highest matmul precision."""
    arrays = {k: v for k, v in kwargs.items() if hasattr(v, "shape")}
    static = {k: v for k, v in kwargs.items() if k not in arrays}
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda v, x, a: model.apply(v, x, **a, **static))(
            variables, jnp.asarray(x), arrays)


def port_apply(model, x, **kwargs):
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(x)), **kwargs).numpy()
