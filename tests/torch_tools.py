"""Shared set-up of the tools tests (``test_torch_cli_test.py``,
``test_torch_webcam.py``, ``test_torch_tools.py``,
``test_torch_flax_ckpt.py``): seeded variables of a JAX detector, a
synthetic scene, a narrow detector checkpoint
written by the JAX package (``make_flax_fixture.write_detector``) with its
batch statistics taken from that scene, recorders of what the overlays are
drawn from, and a forward that hands the JAX package's maps to the port."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_flax_fixture import write_detector  # noqa: E402

ATOL = 5e-5   # the repo's model parity tolerance (tests/test_models.py)


def random_detector_variables(model, shape, seed: int = 0) -> dict:
    """Seeded numpy variables of ``model``'s tree (``jax.eval_shape``, no
    init run): kernels of variance 1/fan_in, BN scales and variances near
    1, biases, shifts and means near 0."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(shape), train=False))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        noise = rs.randn(*leaf.shape)
        if name == "kernel":
            value = noise / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("scale", "var"):
            value = 1 + np.abs(noise) * 0.1
        else:
            value = noise * 0.05
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def scene_and_ckpt(root: str, seed: int = 3) -> dict:
    """A 256x256 synthetic test scene, the JAX ``.ckpt`` (with its widths
    sidecar) whose statistics are the scene's, and that checkpoint's JAX
    eval maps of the scene, preprocessed as ``cli/test`` does."""
    from db_text_minimal_tpu_torch.data.synthetic import generate
    from db_text_minimal_tpu_torch.utils import read_img, test_preprocess

    section = generate(os.path.join(root, "ds"), n_train=1, n_test=1,
                       size=256, seed=seed)
    image = os.path.join(section["test_dir"],
                         sorted(os.listdir(section["test_dir"]))[0])
    x = test_preprocess(read_img(image)[0])
    ckpt = os.path.join(root, "det.ckpt")
    maps = write_detector(ckpt, x)
    return {"image": image, "ckpt": ckpt, "x": x, "maps": maps}


class Recorder:
    """Wraps ``fn``; ``calls`` keeps (args, kwargs, result) of each call."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out


class FakePlt:
    """Stands in for the JAX overlays' ``matplotlib.pyplot``: keeps each
    ``imshow``'s array, colour map and alpha, and each ``savefig`` path
    (an empty file)."""

    def __init__(self):
        self.shown = []
        self.saved = []

    def figure(self, *args, **kwargs):
        pass

    def imshow(self, array, cmap=None, alpha=None):
        self.shown.append((np.array(array), cmap, alpha))

    def savefig(self, path, **kwargs):
        open(path, "wb").close()
        self.saved.append(path)

    def close(self):
        pass


def drawn_layers(overlay_calls) -> list:
    """The port's ``overlay`` calls as the JAX figure's ``imshow`` list:
    (array, colour map, alpha), the base image first."""
    shown = []
    for (image, layers, _), _, _ in overlay_calls:
        shown.append((np.array(image), None, None))
        shown += [(np.array(m), cmap, alpha) for m, cmap, alpha in layers]
    return shown


def forward_of(maps: np.ndarray):
    """A port inference forward that returns the given maps (the JAX
    package's) whatever it is given, as a float32 CPU tensor."""
    def forward(_x):
        return torch.from_numpy(np.array(maps, np.float32))

    return forward
