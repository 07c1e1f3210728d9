"""One train step of the port's other detector families against the JAX
package's on the CPU: deformable_resnet18 + FPN (the offsets under
``dcn_offset_lr_mult`` 0.1) and resnet18 + FPEM_FFM. Helpers and the
``family`` fixture in ``torch_families``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from db_text_minimal_tpu.config import default_config as jax_default_config
from db_text_minimal_tpu.train import trainer as jax_trainer
from db_text_minimal_tpu_torch.config import default_config
from db_text_minimal_tpu_torch.data.scenes import text_batch
from db_text_minimal_tpu_torch.models import DBTextModel
from db_text_minimal_tpu_torch.train import trainer as T
from db_text_minimal_tpu_torch.weights import state_dict_from_jax
from test_torch_train import _capture_grads
from torch_families import (BATCH, HIGHEST, LR, SIZE, family,  # noqa: F401
                            np_tree, zeros_input)

torch.set_num_threads(1)


def test_one_train_step_matches_jax(family):
    """One train step at 64², batch 2, ``--reduction none``, from flax's
    init and the same batch (``tests/test_torch_train.py``'s setting): the
    five losses at rtol 1e-4; every gradient leaf within 2e-2 of its norm
    (the conv biases that a train-mode BN follows, whose true gradient is
    0 and whose f32 noise has a norm under 1e-4, left out): most leaves
    lie within 1.5e-3, and a BN shift's gradient, each entry a sum over
    its channel whose terms cancel, up to 8e-3 on one thread; and the
    updated weights of the port's optimizer, fed the JAX gradients,
    against the JAX optimizer's at 1e-7 plus one f32 ulp
    (deformable_resnet18 under ``dcn_offset_lr_mult`` 0.1, JAX's
    ``optax.masked(optax.scale(0.1))``: its offsets move by lr · 0.1)."""
    mult = 0.1 if family["backbone"].startswith("deformable") else 1.0
    jm = family["jax"]
    v = np_tree(jax.jit(lambda k: jm.init(k, zeros_input()))(
        jax.random.PRNGKey(0)))
    params, stats = v["params"], v["batch_stats"]
    jcfg = jax_default_config()
    jcfg.optimizer.dcn_offset_lr_mult = mult
    jcfg.optimizer.reduction = "none"
    capture = _capture_grads()
    step = jax.jit(jax_trainer.build_train_step(jm, capture, jcfg))
    state = jax_trainer.TrainState(
        params=params, batch_stats=stats, opt_state=capture.init(params),
        step=jnp.zeros((), jnp.int32))
    batch = text_batch(5, BATCH, SIZE)
    jbatch = {k: jnp.asarray(a) for k, a in T.array_batch(batch).items()}
    with jax.default_matmul_precision(HIGHEST):
        new, loss, _, _ = step(state, jbatch, jnp.float32(LR))
    grads = np_tree(new.opt_state)
    tx = jax_trainer.make_optimizer(jcfg)
    updates, _ = tx.update(grads, tx.init(params), params)
    updated = state_dict_from_jax(np_tree(jax.tree.map(
        lambda p, u: p - jnp.float32(LR) * u, params, updates)), {})

    cfg = default_config()
    cfg.optimizer.dcn_offset_lr_mult = mult
    cfg.optimizer.reduction = "none"
    model = DBTextModel(backbone_name=family["backbone"],
                        neck_name=family["neck"])
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    _, ploss, _, _ = T.build_train_step(cfg)(
        T.TrainState(model, T.make_optimizer(cfg, model)),
        T.to_device(batch, torch.device("cpu")), LR)
    for name in loss._fields:
        np.testing.assert_allclose(float(getattr(ploss, name)),
                                   float(getattr(loss, name)), rtol=1e-4,
                                   err_msg=name)
    carried = state_dict_from_jax(grads, {})
    for name, p in model.named_parameters():
        ref = carried[name]
        if ref.norm() >= 1e-4:
            gap = (p.grad - ref).norm() / ref.norm()
            assert gap <= 2e-2, (name, gap.item())

    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    optimizer = T.make_optimizer(cfg, model)
    for name, p in model.named_parameters():
        p.grad = carried[name]
    T.set_lr(optimizer, LR)
    optimizer.step()
    before = state_dict_from_jax(params, {})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   updated[name].numpy(), rtol=2.0 ** -23,
                                   atol=1e-7, err_msg=name)
        if "offset_conv" in name:
            moved = (p.detach() - before[name]).abs().max()
            assert 0.5 * LR * mult < moved <= LR * mult * (1 + 1e-5), name
