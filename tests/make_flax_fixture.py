"""Write the committed Flax fixture: a narrow resnet18 + FPN + DBHead
detector checkpoint written by the JAX package, and its maps.

    JAX_PLATFORMS=cpu python tests/make_flax_fixture.py [OUT_DIR]

writes, into ``tests/fixtures`` by default:

- ``flax_det.ckpt``: the JAX ``save_checkpoint`` (flax msgpack) of
  ``{"params", "batch_stats"}``, initialised from ``PRNGKey(SEED)`` at the
  widths of ``WIDTHS``, the batch statistics brought to those of
  ``fixture_input()`` (40 train-mode forwards), so that the eval-mode maps
  are neither flat nor saturated;
- ``flax_det.ckpt.widths.json``: its widths sidecar (JAX
  ``models.prune.save_widths``);
- ``flax_det_maps.npy``: the eval-mode float32 maps of ``fixture_input()``.

The files are deterministic: ``tests/test_torch_flax_ckpt.py`` runs this
script and compares the output with the committed files byte for byte.
The port reads them without JAX (``chip_smoke.py``, the tools phase)."""

import os
import sys

import numpy as np

SEED = 0
SIZE = 64
WIDTHS = {"backbone_hidden": [8] * 8, "fpn_inner_quarter": 8,
          "fpn_out": 16, "head_width": 16}
NAMES = ("flax_det.ckpt", "flax_det.ckpt.widths.json", "flax_det_maps.npy")
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures")


def fixture_input() -> np.ndarray:
    """The seeded NHWC float32 input of the fixture's maps."""
    return np.random.RandomState(SEED).uniform(
        -120, 120, (1, SIZE, SIZE, 3)).astype(np.float32)


def write_detector(ckpt: str, x: np.ndarray, widths: dict = WIDTHS,
                   seed: int = SEED) -> np.ndarray:
    """Write to ``ckpt`` (with its widths sidecar) a JAX resnet18 + FPN +
    DBHead at ``widths``, initialised from ``PRNGKey(seed)``, its batch
    statistics brought to those of the NHWC batch ``x`` by 40 train-mode
    forwards; returns its eval-mode float32 maps of ``x``."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from db_text_minimal_tpu.models import DBTextModel
    from db_text_minimal_tpu.models.prune import (save_widths,
                                                  widths_to_model_kwargs)
    from db_text_minimal_tpu.train.checkpoints import save_checkpoint

    model = DBTextModel(**widths_to_model_kwargs(widths))
    x = jnp.asarray(x)
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(seed), x, train=False)
    params, stats = variables["params"], variables["batch_stats"]

    @jax.jit
    def update(params, stats, x):
        _, mutated = model.apply({"params": params, "batch_stats": stats},
                                 x, train=True, mutable=["batch_stats"])
        return mutated["batch_stats"]

    for _ in range(40):
        stats = update(params, stats, x)
    maps = jax.jit(model.apply, static_argnames="train")(
        {"params": params, "batch_stats": stats}, x, train=False)
    save_checkpoint(ckpt, {"params": params, "batch_stats": stats})
    save_widths(ckpt, widths)
    return np.asarray(maps, np.float32)


def main(out_dir: str = DEFAULT_DIR) -> list:
    os.makedirs(out_dir, exist_ok=True)
    maps = write_detector(os.path.join(out_dir, NAMES[0]), fixture_input())
    np.save(os.path.join(out_dir, NAMES[2]), maps)
    return [os.path.join(out_dir, n) for n in NAMES]


if __name__ == "__main__":
    print("\n".join(main(*sys.argv[1:])))
