"""The PyTorch port's training step against the JAX package on the CPU.

One train step at 64², batch 2, from the same Flax init and the same batch,
for both OHEM reductions: the five losses, every gradient, the updated BN
statistics and the confusion histogram against the JAX ``build_train_step``.
Adam is held apart, on the JAX gradients carried across: both frameworks
leave f32 noise of ~1e-10 on the conv biases that a train-mode BN follows
(their true gradient is 0), and Adam's first step moves such a leaf by
lr·g/(|g| + 1e-8), an arbitrary amount in (−lr, lr), so the parameters after
a full step are not comparable. Also the DB step K2 and its plain versions,
BN in train mode, and ``Trainer.fit`` end to end on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from db_text_minimal_tpu.config import default_config as jax_default_config
from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.ops.pallas import db_step as jax_db_step_mod
from db_text_minimal_tpu.train import trainer as jax_trainer
from db_text_minimal_tpu.utils.torch_port import torch_state_dict_to_flax
from db_text_minimal_tpu_torch.config import default_config
from db_text_minimal_tpu_torch.data.scenes import text_batch
from db_text_minimal_tpu_torch.models import DBTextModel
from db_text_minimal_tpu_torch.models.layers import batch_norm
from db_text_minimal_tpu_torch.ops import db_step as D
from db_text_minimal_tpu_torch.train import trainer as T
from db_text_minimal_tpu_torch.train.checkpoints import restore_checkpoint
from db_text_minimal_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)

SIZE, BATCH, LR = 64, 2, 0.005


# ------------------------------------------------------------ K1 and K2 ----

def test_fused_db_step_plain_matches_jax():
    rs = np.random.RandomState(0)
    p = rs.rand(2, 64, 128).astype(np.float32)
    t = rs.rand(2, 64, 128).astype(np.float32)
    p[0, 0, :4] = [0.3, 0.30000001, 0.29999998, 1.0]
    ref_b, ref_m = jax_db_step_mod.fused_db_step(jnp.asarray(p),
                                                 jnp.asarray(t), 50.0, 0.3)
    bhat, bitmap = D.fused_db_step(torch.from_numpy(p), torch.from_numpy(t),
                                   50.0, 0.3)
    assert bhat.dtype == bitmap.dtype == torch.float32
    np.testing.assert_allclose(bhat.numpy(), np.asarray(ref_b), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(bitmap.numpy(), np.asarray(ref_m))


def test_db_step_forward_and_grad_match_jax():
    rs = np.random.RandomState(1)
    p = rs.rand(2, 1, 16, 128).astype(np.float32)
    t = rs.rand(2, 1, 16, 128).astype(np.float32)

    def via_jax(p, t):
        return jnp.sum(jnp.cos(jax_db_step_mod.db_step(p, t, 50.0)))

    ref_b = jax_db_step_mod.db_step(jnp.asarray(p), jnp.asarray(t), 50.0)
    ref_gp, ref_gt = jax.grad(via_jax, argnums=(0, 1))(jnp.asarray(p),
                                                       jnp.asarray(t))
    tp = torch.from_numpy(p).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    out = D.db_step(tp, tt, 50.0)
    gp, gt = torch.autograd.grad(torch.cos(out).sum(), (tp, tt))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_b),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(gp.numpy(), np.asarray(ref_gp), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(ref_gt), rtol=0,
                               atol=1e-5)
    # the plain version, differentiated by torch, agrees too
    plain = D.db_step_plain(tp, tt, 50.0)
    gp2, _ = torch.autograd.grad(torch.cos(plain).sum(), (tp, tt))
    np.testing.assert_allclose(gp2.numpy(), np.asarray(ref_gp), rtol=0,
                               atol=1e-5)


def test_db_step_backward_takes_the_strided_gradient():
    """The gradient that reaches K2's backward is the last channel of an
    NHWC view: element stride 3. The plain backward and the stride helper
    see it as such."""
    rs = np.random.RandomState(2)
    g_nhwc = torch.from_numpy(rs.randn(2, 8, 16, 3).astype(np.float32))
    g = g_nhwc.permute(0, 3, 1, 2)[:, 2:3]
    assert D.uniform_stride(g) == 3 and not g.is_contiguous()
    assert D.uniform_stride(torch.ones(2, 1, 4, 4)) == 1
    assert D.uniform_stride(torch.ones(1).expand(2, 1, 4, 4)) == 0
    assert D.uniform_stride(torch.ones(4, 6)[:, :3]) is None
    bhat = torch.from_numpy(rs.rand(2, 1, 8, 16).astype(np.float32))
    dp, dt = D.db_step_backward(g, bhat, 50.0)
    ref = g.contiguous() * (50.0 * bhat * (1.0 - bhat))
    assert torch.equal(dp, ref) and torch.equal(dt, -ref)


# --------------------------------------------------------------- BN --------

def test_batch_norm_train_mode_matches_flax():
    """flax moves the running variance by the BIASED batch variance; on a
    channel of 8 values nn.BatchNorm2d's unbiased rule is 8/7 off."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 2, 2, 3).astype(np.float32) * 1.7 + 0.4   # NHWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_ref, mutated = bn.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
    port = batch_norm(3).train()
    y = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=0, atol=1e-5)
    unbiased = torch.nn.BatchNorm2d(3, momentum=0.1).train()
    unbiased(torch.from_numpy(x).permute(0, 3, 1, 2))
    gap = np.abs(unbiased.running_var.numpy() - np.asarray(stats["var"]))
    assert gap.max() > 1e-3


# ------------------------------------------------- one step against JAX ----

def _capture_grads():
    """An optax transformation that leaves the parameters alone and keeps
    the gradients as its state, so the JAX train step hands them back."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


@pytest.fixture(scope="module")
def init_variables():
    v = JaxDBTextModel().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    return jax.device_get({"params": v["params"],
                           "batch_stats": v["batch_stats"]})


@pytest.fixture(scope="module")
def batch():
    return text_batch(5, BATCH, SIZE)


@pytest.fixture(scope="module", params=["none", "mean"])
def step_pair(request, init_variables, batch):
    """The same train step through the JAX package and through the port."""
    reduction = request.param
    jcfg = jax_default_config()
    jcfg.optimizer.reduction = reduction
    tx = _capture_grads()
    step = jax.jit(jax_trainer.build_train_step(JaxDBTextModel(), tx, jcfg))
    params = init_variables["params"]
    state = jax_trainer.TrainState(
        params=params, batch_stats=init_variables["batch_stats"],
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    jbatch = {k: jnp.asarray(v) for k, v in T.array_batch(batch).items()}
    with jax.default_matmul_precision("highest"):
        new_state, loss_out, hist, _ = step(state, jbatch, jnp.float32(LR))
    ref = jax.device_get({"grads": new_state.opt_state,
                          "stats": new_state.batch_stats,
                          "loss": loss_out, "hist": hist})

    cfg = default_config()
    cfg.optimizer.reduction = reduction
    model = DBTextModel()
    model.load_state_dict(state_dict_from_jax(params,
                                              init_variables["batch_stats"]))
    port_state = T.TrainState(model, T.make_optimizer(cfg, model))
    port_state, port_loss, port_hist, preds = T.build_train_step(cfg)(
        port_state, T.to_device(batch, torch.device("cpu")), LR)
    grads = {name: p.grad for name, p in model.named_parameters()}
    port_grads, _ = torch_state_dict_to_flax(grads, strict=True)
    _, port_stats = torch_state_dict_to_flax(model.state_dict(), strict=True)
    return {"ref": ref, "loss": port_loss, "hist": port_hist,
            "grads": port_grads, "stats": port_stats, "preds": preds,
            "state": port_state, "init": init_variables}


def test_one_step_losses_match_jax(step_pair):
    ref = step_pair["ref"]["loss"]
    for name in ref._fields:
        np.testing.assert_allclose(
            float(getattr(step_pair["loss"], name)),
            float(getattr(ref, name)), rtol=1e-4, err_msg=name)
    assert step_pair["preds"].shape == (BATCH, SIZE, SIZE, 3)
    assert step_pair["state"].step == 1


def test_one_step_gradients_match_jax(step_pair):
    """Every gradient leaf within 1e-3 of that leaf's max |g| (at least 1).
    The two frameworks' f32 convolutions leave ~1e-5 of noise in P − T, and
    B̂ = σ(50(P − T)) multiplies it by up to k/4 = 12.5 on its way into the
    dice gradient; the gap measured on the CPU is 3.5e-4 of a leaf's max at
    most, largest at the stem, at the end of the longest backward path."""
    ref = step_pair["ref"]["grads"]
    got = step_pair["grads"]
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    for (path, r), g in zip(paths, jax.tree.leaves(got)):
        r, g = np.asarray(r), np.asarray(g)
        tol = 1e-3 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_one_step_batch_stats_match_jax(step_pair):
    """Every BN's running mean and variance, c5's included, at atol 1e-5
    plus rtol 1e-4: flax takes the variance as E[x²] − E[x]² in f32, which
    loses digits where the mean is large against the spread, as at the stem
    (running variance ~18 there, gap 3.3e-4). At 64², batch 2, each c5
    channel holds 8 values, where the unbiased rule is 8/7 off and the gap
    exceeds the tolerance."""
    ref, got = step_pair["ref"]["stats"], step_pair["stats"]
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for r, g in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)
    init = step_pair["init"]["batch_stats"]["backbone"]["layer4_1"]["bn2"]
    new = ref["backbone"]["layer4_1"]["bn2"]
    var = np.asarray(new["var"])
    batch_var = (var - 0.9 * init["var"]) / 0.1
    unbiased_gap = np.abs(0.1 * batch_var * (8 / 7 - 1))
    assert (unbiased_gap > 1e-5 + 1e-4 * np.abs(var)).any()


def test_one_step_confusion_hist_matches_jax(step_pair):
    np.testing.assert_array_equal(step_pair["hist"].numpy(),
                                  np.asarray(step_pair["ref"]["hist"]))
    assert step_pair["hist"].sum() == BATCH * SIZE * SIZE


def test_adam_update_on_carried_gradients_matches_optax(step_pair):
    """The port's Adam and the JAX package's optax chain, fed the same (JAX)
    gradients from the same parameters. Tolerance: 1e-7 plus one f32 ulp
    of the parameter, since the last addition rounds p + Δ to p's grid and
    the two compute Δ in another order."""
    init = step_pair["init"]
    grads = step_pair["ref"]["grads"]
    jcfg = jax_default_config()
    tx = jax_trainer.make_optimizer(jcfg)
    updates, _ = tx.update(grads, tx.init(init["params"]), init["params"])
    updates = jax.tree.map(lambda u: -jnp.float32(LR) * u, updates)
    ref = jax.device_get(optax.apply_updates(init["params"], updates))

    model = DBTextModel()
    model.load_state_dict(state_dict_from_jax(init["params"],
                                              init["batch_stats"]))
    optimizer = T.make_optimizer(default_config(), model)
    carried = state_dict_from_jax(grads, {})
    for name, param in model.named_parameters():
        param.grad = carried[name]
    T.set_lr(optimizer, LR)
    optimizer.step()
    got = state_dict_from_jax(ref, {})
    before = state_dict_from_jax(init["params"], {})
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(),
                                   got[name].numpy(), rtol=2.0 ** -23,
                                   atol=1e-7, err_msg=name)
        assert not torch.equal(param.detach(), before[name]), name


def test_amsgrad_gap_between_torch_and_optax():
    """A fault of the JAX package, kept as measured (ROADMAP §3): with
    ``optimizer.amsgrad`` its ``optax.scale_by_amsgrad`` keeps the running
    max of the bias-corrected second moment, torch's Adam (the port's, and
    the reference's) the max of the raw moment, bias-corrected after. One
    parameter from 0, gradients 1, 0, 0, 0.5, -0.2 at lr 0.005, each
    package's own optimizer, the JAX one with the rate applied per step as
    its train step does. Step 1 agrees; the port's rule stays torch's."""
    grads = [1.0, 0.0, 0.0, 0.5, -0.2]
    jcfg = jax_default_config()
    jcfg.optimizer.amsgrad = True
    tx = jax_trainer.make_optimizer(jcfg)
    params = {"w": jnp.zeros((), jnp.float32)}
    opt_state = tx.init(params)
    cfg = default_config()
    cfg.optimizer.amsgrad = True
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.zeros(()))
    optimizer = T.make_optimizer(cfg, model)
    assert optimizer.param_groups[0]["amsgrad"]
    gaps = []
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.float32(g)}, opt_state,
                                       params)
        params = optax.apply_updates(
            params, jax.tree.map(lambda u: -jnp.float32(LR) * u, updates))
        model.w.grad = torch.tensor(g)
        T.set_lr(optimizer, LR)
        optimizer.step()
        gaps.append(abs(model.w.item() - float(params["w"])))
    assert gaps[0] < 1e-7      # they place eps apart: f32 noise
    # torch's rule by hand after step 5 (step 2: -0.0083486)
    np.testing.assert_allclose(model.w.item(), -0.016313158, rtol=1e-5)
    np.testing.assert_allclose([gaps[1], gaps[4]], [9.8e-4, 4.6e-3],
                               rtol=0.02)


# --------------------------------------------------- the epoch loop --------

def _cfg(root, **metric):
    cfg = default_config()
    cfg.meta.device = "cpu"
    cfg.meta.root_dir = str(root)
    cfg.hps.img_size = SIZE
    cfg.hps.batch_size = BATCH
    cfg.hps.log_iter = 1
    cfg.logging.logger_file = None
    cfg.metric.is_output_polygon = False
    cfg.metric.update(metric)
    return cfg


def test_trainer_fit_on_cpu_writes_checkpoints_and_resumes(tmp_path):
    train = [text_batch(10 + i, BATCH, SIZE) for i in range(2)]
    test = [text_batch(20 + i, 1, SIZE) for i in range(2)]
    cfg = _cfg(tmp_path)
    trainer = T.Trainer(cfg, train, test)
    state, history = trainer.fit(no_epochs=2)
    assert len(history) == 2 and state.step == 4
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["test_loss"])
               and 0.0 <= h["hmean"] <= 1.0 for h in history)
    assert len(trainer.loss_log) == 4
    assert all(np.isfinite(v) for row in trainer.loss_log
               for v in row.values())
    models = tmp_path / "models"
    for name in ("best_cp.ckpt", "last_cp.ckpt", "best_hmean_cp.ckpt"):
        assert (models / name).exists() and (models / (name + ".json")).exists()

    saved = restore_checkpoint(str(models / "last_cp.ckpt"))
    current = state.state_dict()
    for key, value in current["model"].items():
        assert torch.equal(saved["model"][key], value), key
    moments = [s["exp_avg_sq"] for s in saved["optimizer"]["state"].values()]
    assert len(moments) == len(list(state.model.parameters()))

    resumed_trainer = T.Trainer(cfg, train, test)
    resumed = resumed_trainer.resume_state(str(models / "last_cp.ckpt"))
    assert resumed.step == 4 and resumed_trainer.global_step == 4
    for p_now, p_back in zip(state.model.parameters(),
                             resumed.model.parameters()):
        assert torch.equal(p_now, p_back)
        now, back = state.optimizer.state[p_now], \
            resumed.optimizer.state[p_back]
        assert torch.equal(now["exp_avg"], back["exp_avg"])
        assert torch.equal(now["exp_avg_sq"], back["exp_avg_sq"])
    resumed, loss, _, _ = resumed_trainer.train_epoch(resumed, 2)
    assert np.isfinite(loss) and resumed.step == 6


def test_trainer_host_representer_and_polygon_mode(tmp_path):
    """metric.device_boxes_in_train=False takes the host representer in
    rect mode; the default configuration (polygon mode) fits and evaluates
    through the host polygon representer, and its hmean equals host
    polygons + QuadMetric over the trained model's own preds."""
    from db_text_minimal_tpu_torch.metrics import QuadMetric
    from db_text_minimal_tpu_torch.postprocess import SegDetectorRepresenter

    test = [text_batch(30, 1, SIZE)]
    trainer = T.Trainer(_cfg(tmp_path, device_boxes_in_train=False), [],
                        test)
    state = trainer.init_state()
    test_loss, _, recall, precision, hmean = trainer.eval_epoch(state)
    assert np.isfinite(test_loss) and 0.0 <= hmean <= 1.0

    cfg = default_config()
    cfg.meta.device = "cpu"
    cfg.meta.root_dir = str(tmp_path)
    cfg.hps.img_size = SIZE
    cfg.hps.batch_size = BATCH
    cfg.logging.logger_file = None
    assert cfg.metric.is_output_polygon is True
    train = [text_batch(31, BATCH, SIZE)]
    test = [text_batch(32 + i, 1, SIZE) for i in range(2)]
    poly = T.Trainer(cfg, train, test)
    state, history = poly.fit(no_epochs=1)
    assert len(history) == 1 and 0.0 <= history[0]["hmean"] <= 1.0
    rep = SegDetectorRepresenter(cfg.metric.thred_text_score,
                                 cfg.metric.prob_threshold,
                                 unclip_ratio=cfg.metric.unclip_ratio)
    metric, raw = QuadMetric(), []
    for batch in test:
        preds = poly._eval_step(state, T.to_device(batch, poly.device))[0]
        out = rep({"shape": [(SIZE, SIZE)]}, preds.numpy(),
                  is_output_polygon=True)
        assert all(b.dtype == np.int64 and b.shape[1] == 2 for b in out[0][0])
        raw.append(metric.validate_measure(batch, out))
    assert metric.gather_measure(raw)["fmeasure"].avg == history[0]["hmean"]


def test_finetune_and_pretrained_backbone_warm_start(tmp_path):
    src = DBTextModel()
    src.reset_parameters(torch.Generator().manual_seed(9))
    torch.save(src.state_dict(), str(tmp_path / "ft.pth"))
    torch.save({**src.backbone.state_dict(), "fc.weight": torch.zeros(2)},
               str(tmp_path / "resnet18.pth"))
    cfg = _cfg(tmp_path)
    cfg.model.finetune_cp_path = "ft.pth"
    trainer = T.Trainer(cfg)
    assert trainer.base_lr == cfg.optimizer.lr_finetune
    state = trainer.init_state()
    for key, value in src.state_dict().items():
        assert torch.equal(state.model.state_dict()[key], value), key
    cfg = _cfg(tmp_path)
    cfg.model.pretrained_backbone_path = str(tmp_path / "resnet18.pth")
    state = T.Trainer(cfg).init_state()
    for key, value in src.backbone.state_dict().items():
        assert torch.equal(state.model.backbone.state_dict()[key], value)
    assert not os.path.exists(tmp_path / "models")
