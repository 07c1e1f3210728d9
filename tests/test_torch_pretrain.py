"""The port's backbone pretraining (``train/backbone_pretrain``,
``cli/pretrain_backbone``) against the JAX package's on the CPU:

- the scene loader and both samplers give the JAX package's crops, labels
  and weights exactly, draw after draw, from the same seed;
- ``BackboneDense`` and ``BackboneClassifier`` on the same (JAX-drawn)
  weights give the JAX logits in eval and in train mode within 5e-5 (the
  repo's model parity tolerance) plus 2e-5 of the largest logit (float32
  sums of ~10^4 products; random weights' logits reach ~100);
- three dense-pretext steps from the same weights on the same crops:
  optax's Adam under its cosine decay against ``torch.optim.Adam`` at the
  port's schedule. The first loss agrees within rtol 1e-5. After the
  first step all but 1e-3 of the weights agree within 1e-6 and none is
  further off than twice the rate: Adam moves a weight by about the rate
  whatever its gradient's size, so a gradient within rounding of 0 moves
  it either way (3e-5 to 7e-5 of the weights, by the CPU's thread count).
  Those weights move the next losses by up to 7.5e-4 of their value
  (measured at 1 CPU thread): rtol 2e-3;
- the ``.pth`` that ``cli/pretrain_backbone`` writes (both pretexts) loads
  into the port's ``Trainer`` and into the JAX package's
  ``load_pretrained_backbone``, each with the exported weights."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from db_text_minimal_tpu.train import backbone_pretrain as J
from db_text_minimal_tpu_torch.train import backbone_pretrain as P
from db_text_minimal_tpu_torch.weights import state_dict_from_jax
from torch_tools import random_detector_variables

ATOL = 5e-5


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from db_text_minimal_tpu_torch.data.synthetic import generate

    section = generate(str(tmp_path_factory.mktemp("pretrain")),
                       n_train=3, n_test=1, size=256, seed=1)
    return section


def test_scene_loader_and_samplers_give_the_jax_crops(scenes):
    args = (scenes["train_dir"], scenes["train_gt_dir"])
    images, bboxes = P.load_scene_bboxes(*args)
    jimages, jbboxes = J.load_scene_bboxes(*args)
    assert len(images) == 3 and all(len(b) for b in bboxes)
    for a, b in zip(images + bboxes, jimages + jbboxes):
        np.testing.assert_array_equal(a, b)
    for sample, jsample, n in ((P.sample_patches_dense,
                                J.sample_patches_dense, 6),
                               (P.sample_patches, J.sample_patches, 8)):
        rng, jrng = np.random.RandomState(4), np.random.RandomState(4)
        for _ in range(3):
            got = sample(images, bboxes, rng, n)
            ref = jsample(jimages, jbboxes, jrng, n)
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype and g.shape == r.shape
                np.testing.assert_array_equal(g, r)
    assert ref[1].sum() == 4      # the classes alternate


def _jax_variables(model, seed: int = 0):
    return random_detector_variables(model, (1, 128, 128, 3), seed)


def _port_state(variables: dict) -> dict:
    """The JAX pretext model's variables as the port model's state_dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd = state_dict_from_jax({"backbone": p["backbone"]},
                             {"backbone": s["backbone"]})
    head = "cell_head" if "cell_head" in p else "fc"
    kernel = np.asarray(p[head]["kernel"])
    kernel = (np.transpose(kernel, (3, 2, 0, 1)) if kernel.ndim == 4
              else kernel.T)
    sd[f"{head}.weight"] = torch.from_numpy(kernel.copy())
    sd[f"{head}.bias"] = torch.from_numpy(np.array(p[head]["bias"]))
    return sd


PRETEXTS = {"dense": (J.BackboneDense, P.BackboneDense),
            "classify": (J.BackboneClassifier, P.BackboneClassifier)}


@pytest.mark.parametrize("pretext", list(PRETEXTS))
def test_pretext_models_match_jax(pretext):
    jcls, pcls = PRETEXTS[pretext]
    jmodel, model = jcls(), pcls()
    variables = _jax_variables(jmodel)
    model.load_state_dict(_port_state(variables), strict=True)
    x = np.random.RandomState(2).uniform(-120, 120, (2, 128, 128, 3)
                                         ).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    jtrain, _ = jmodel.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
        got_train = model.train()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == ((2, 16, 16) if pretext == "dense"
                                      else (2, 2))
    for g, r in ((got, ref), (got_train, np.asarray(jtrain))):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=ATOL + 2e-5 * np.abs(r).max())


def test_dense_steps_match_jax(scenes):
    """Three steps at batch 4 of 128x128 crops, lr 2e-3 decaying over the
    three: the port's ``build_step`` with ``dense_loss`` against the JAX
    package's step (its ``loss_fn`` as ``pretrain_backbone_dense`` has
    it, optax's ``adam`` under ``cosine_decay_schedule``)."""
    steps, lr = 3, 2e-3
    images, bboxes = P.load_scene_bboxes(scenes["train_dir"],
                                         scenes["train_gt_dir"])
    rng = np.random.RandomState(0)
    batches = [P.sample_patches_dense(images, bboxes, rng, 4)
               for _ in range(steps)]

    jmodel = J.BackboneDense()
    variables = _jax_variables(jmodel, seed=1)
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps))
    opt_state = tx.init(params)

    def jstep(params, stats, opt_state, x, y, w):
        def loss_fn(p):
            logits, mutated = jmodel.apply(
                {"params": p, "batch_stats": stats}, x, train=True,
                mutable=["batch_stats"])
            pos = (y * w).sum() + 1.0
            neg = ((1 - y) * w).sum() + 1.0
            cw = w * (y * (0.5 / pos) + (1 - y) * (0.5 / neg))
            bce = optax.sigmoid_binary_cross_entropy(logits, y)
            return (bce * cw).sum(), mutated["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    model = P.BackboneDense()
    model.load_state_dict(_port_state(variables), strict=True)
    step, _ = P.build_step(model, P.dense_loss, torch.device("cpu"))
    schedule = P.cosine_decay_schedule(lr, steps)
    ref, got = [], []
    for i, batch in enumerate(batches):
        params, stats, opt_state, loss = jstep(
            params, stats, opt_state, *map(jnp.asarray, batch))
        ref.append(float(loss))
        got.append(float(step(schedule(i), *batch)[0]))
        if i == 0:
            moved = _port_state({"params": jax.device_get(params),
                                 "batch_stats": jax.device_get(stats)})
            gaps = np.concatenate([
                (value - moved[key]).abs().numpy().ravel()
                for key, value in model.state_dict().items()
                if value.is_floating_point()])
            assert (gaps > 1e-6).mean() < 1e-3 and gaps.max() <= 2.001 * lr
    assert len(set(ref)) == steps
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=2e-3)


@pytest.mark.parametrize("pretext", list(PRETEXTS))
def test_exported_pth_loads_into_both_trainers(scenes, pretext, tmp_path):
    from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
    from db_text_minimal_tpu.utils.torch_port import \
        load_pretrained_backbone
    from db_text_minimal_tpu_torch.cli import pretrain_backbone
    from db_text_minimal_tpu_torch.config import default_config
    from db_text_minimal_tpu_torch.train.trainer import Trainer

    out = str(tmp_path / "bb.pth")
    result = pretrain_backbone.main([
        "--train_dir", scenes["train_dir"], "--gt_dir",
        scenes["train_gt_dir"], "--out", out, "--pretext", pretext,
        "--steps", "2", "--batch_size", "4", "--limit_images", "3",
        "--device", "cpu"])
    assert result["path"] == out and result["steps"] == 2
    assert 0.0 <= result["cell_accuracy" if pretext == "dense"
                         else "accuracy"] <= 1.0
    sd = torch.load(out, weights_only=True)
    assert "conv1.weight" in sd and "layer4.1.bn2.running_var" in sd
    assert not any(k.startswith(("fc.", "cell_head.")) for k in sd)

    cfg = default_config()
    cfg.meta.device = "cpu"
    cfg.model.pretrained_backbone_path = out
    state = Trainer(cfg).init_state()
    for key, value in state.model.backbone.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(value, sd[key], rtol=0, atol=0)

    v = jax.device_get(JaxDBTextModel().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    params, stats = load_pretrained_backbone(out, v["params"],
                                             v["batch_stats"])
    np.testing.assert_array_equal(
        params["backbone"]["conv1"]["kernel"],
        np.transpose(sd["conv1.weight"].numpy(), (2, 3, 1, 0)))
    np.testing.assert_array_equal(
        stats["backbone"]["layer4_1"]["bn2"]["var"],
        sd["layer4.1.bn2.running_var"].numpy())
