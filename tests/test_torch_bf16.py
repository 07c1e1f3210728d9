"""The port's bfloat16 compute against the JAX package's on the CPU.

``DBTextModel(compute_dtype=torch.bfloat16)`` against flax's
``DBTextModel(dtype=jnp.bfloat16)`` on the 64×64 nudged weights of
``tests/test_torch_models.py``: block by block on the JAX blocks' own
inputs, where the two agree to float32 noise, and end to end, where they
cannot. A bfloat16 network amplifies a rounding flip: an f32 accumulation
that lands on the other side of a bfloat16 rounding boundary in one
implementation sends one element one ulp (2^-8) away, and each later layer
sums such elements. Measured here, the share of elements that differ grows
from 1.5e-4 at the first block's conv to 0.73 at c5, and the JAX package
against itself, with only the summation order of layer 1 changed (its 64
channels permuted, the same function), lies 0.00219 from its own output,
0.79 of its bf16-against-fp32 gap (0.00277). So the end-to-end tolerance
is that self-distance, computed in the test. Then one bf16 train step
against the JAX bf16 train step, and the choice of the compute dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from db_text_minimal_tpu.config import default_config as jax_default_config
from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.models.head import fuse_variables as jax_fuse
from db_text_minimal_tpu.train import trainer as jax_trainer
from db_text_minimal_tpu.utils.torch_port import torch_state_dict_to_flax
from db_text_minimal_tpu_torch.cli.common import default_dtype, load_model
from db_text_minimal_tpu_torch.config import default_config
from db_text_minimal_tpu_torch.data.scenes import text_batch
from db_text_minimal_tpu_torch.models import DBTextModel
from db_text_minimal_tpu_torch.models.layers import Conv2d, ConvTranspose2d
from db_text_minimal_tpu_torch.train import trainer as T
from db_text_minimal_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)

SIZE, BATCH, LR = 64, 2, 0.005


@pytest.fixture(scope="module")
def jax_variables():
    """Flax init at 64×64 with every 1-D leaf moved by seeded noise, as in
    ``tests/test_torch_models.py``."""
    v = jax.device_get(JaxDBTextModel().init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rs = np.random.RandomState(1)

    def nudge(a):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        return (a + np.abs(rs.randn(*a.shape)) * 0.05).astype(a.dtype)

    return {"params": jax.tree.map(nudge, v["params"]),
            "batch_stats": jax.tree.map(nudge, v["batch_stats"])}


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(
        np.float32) * 2 - 1


def _port(variables, head="DBHead", dtype=torch.bfloat16):
    model = DBTextModel(head_name=head, compute_dtype=dtype).eval()
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
    return model


def _permute_layer1(variables, seed=5):
    """The same network with layer 1's 64 channels in another order: every
    tensor of c2's width permuted, so the function is unchanged and only
    the order of the sums over those channels differs."""
    perm = np.random.RandomState(seed).permutation(64)
    v = jax.tree.map(np.array, variables)
    params, stats = v["params"]["backbone"], v["batch_stats"]["backbone"]

    def bn(p, s):
        for leaves in (p, s):
            for k in leaves:
                leaves[k] = leaves[k][perm]

    params["conv1"]["kernel"] = params["conv1"]["kernel"][..., perm]
    bn(params["bn1"], stats["bn1"])
    for block in ("layer1_0", "layer1_1"):
        for conv in ("conv1", "conv2"):
            k = params[block][conv]["kernel"]
            params[block][conv]["kernel"] = k[:, :, perm][..., perm]
        for name in ("bn1", "bn2"):
            bn(params[block][name], stats[block][name])
    for conv in ("conv1", "downsample_conv"):
        k = params["layer2_0"][conv]["kernel"]
        params["layer2_0"][conv]["kernel"] = k[:, :, perm]
    reduce_c2 = v["params"]["segmentation_body"]["reduce_conv_c2"]["conv"]
    reduce_c2["kernel"] = reduce_c2["kernel"][:, :, perm]
    return v


@pytest.mark.parametrize("head", ["DBHead", "FusedDBHead"])
def test_bf16_forward_matches_jax(head, jax_variables, images):
    """End to end, the port's bf16 maps lie no farther from the JAX bf16
    maps (mean abs) than the JAX bf16 maps of the same network with layer
    1's sums reordered do (0.00169 against 0.00219 on the CPU), and that
    is less than the JAX bf16-against-fp32 gap (0.00277). The output is
    float32, as flax's."""
    variables = jax_variables if head == "DBHead" else jax_fuse(
        jax_variables)
    x = jnp.asarray(images)
    with jax.default_matmul_precision("highest"):
        ref32 = np.asarray(JaxDBTextModel(head_name=head).apply(variables, x))
        model16 = JaxDBTextModel(head_name=head, dtype=jnp.bfloat16)
        ref16 = np.asarray(model16.apply(variables, x))
        reordered = np.asarray(model16.apply(_permute_layer1(variables), x))
    with torch.no_grad():
        out = _port(variables, head)(torch.from_numpy(images))
    assert out.dtype == torch.float32 and out.shape == (2, SIZE, SIZE, 2)
    got = np.abs(out.numpy() - ref16).mean()
    noise = np.abs(reordered - ref16).mean()
    gap = np.abs(ref16 - ref32).mean()
    assert noise < gap
    assert got <= noise, (got, noise, gap)


def _nchw(a) -> torch.Tensor:
    a = np.asarray(a)
    dtype = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(a.astype(np.float32)).permute(0, 3, 1, 2).to(
        dtype)


def test_bf16_blocks_match_jax_on_its_inputs(jax_variables, images):
    """Each block of the port, fed the JAX bf16 model's own input to that
    block, gives the JAX block's output in the same dtype (bf16 out of a
    conv, f32 out of a BN, a residual block, the FPN and the head) within
    a mean relative difference of 1e-4: 3.5e-5 at most on the CPU, where
    a model whose BN handed bf16 on (as autocast's would) reads 6.6e-4 to
    2.1e-3 and the fp32 model 1.9e-3 to 5.9e-3."""
    _, state = JaxDBTextModel(dtype=jnp.bfloat16).apply(
        jax_variables, jnp.asarray(images), capture_intermediates=True,
        mutable=["intermediates"])
    inter = state["intermediates"]

    def ref(*path):
        node = inter
        for key in path:
            node = node[key]
        return node["__call__"][0]

    model = _port(jax_variables)
    checked = []

    def check(name, got, want):
        assert got.dtype == _nchw(want).dtype, name
        want = _nchw(want).float()
        rel = ((got.float() - want).abs().mean() / want.abs().mean()).item()
        assert rel <= 1e-4, (name, rel)
        checked.append(name)

    with torch.no_grad():
        x = torch.from_numpy(images).permute(0, 3, 1, 2)
        check("stem conv", model.backbone.conv1(x), ref("backbone", "conv1"))
        h = F.max_pool2d(F.relu(_nchw(ref("backbone", "bn1"))), 3, 2, 1)
        feats = []
        for stage in range(1, 5):
            for b in range(2):
                name = f"layer{stage}_{b}"
                block = getattr(model.backbone, f"layer{stage}")[b]
                check(name, block(h), ref("backbone", name))
                h = _nchw(ref("backbone", name))
            feats.append(h)
        check("fpn", model.segmentation_body(feats),
              ref("segmentation_body"))
        body = _nchw(ref("segmentation_body"))
        check("head", model.segmentation_head(body),
              ref("segmentation_head"))
        check("binarize conv1", model.segmentation_head.binarize[0](body),
              ref("segmentation_head", "binarize", "conv1"))
    assert len(checked) == 12


def test_bf16_keeps_the_state_dict_and_the_fp32_path(jax_variables,
                                                     images):
    """A bf16 model has the fp32 model's state_dict keys, every entry
    float32; set back to fp32 it gives the fp32 model's maps bit for
    bit."""
    model16 = _port(jax_variables)
    model32 = _port(jax_variables, dtype=torch.float32)
    sd16, sd32 = model16.state_dict(), model32.state_dict()
    assert list(sd16) == list(sd32)
    assert all(v.dtype == sd32[k].dtype for k, v in sd16.items())
    convs = [m for m in model16.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    # resnet18 20 (3 downsample), FPN 8, the two head branches 3 each
    assert len(convs) == 34
    assert all(isinstance(m, (Conv2d, ConvTranspose2d)) for m in convs)
    assert {m.compute_dtype for m in convs} == {torch.bfloat16}
    x = torch.from_numpy(images)
    with torch.no_grad():
        assert torch.equal(model16.set_compute_dtype(torch.float32)(x),
                           model32(x))


# ----------------------------------------------------- one train step ----

@pytest.fixture(scope="module")
def bf16_step():
    """One train step at 64², batch 2, under ``--reduction none``, from
    the same flax init and batch: the JAX package's with a bf16 model and
    its Adam, and the port's with a bf16 model, and the port's in fp32."""
    v = jax.device_get(JaxDBTextModel().init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    batch = text_batch(5, BATCH, SIZE)
    jcfg = jax_default_config()
    jcfg.optimizer.reduction = "none"
    tx = jax_trainer.make_optimizer(jcfg)
    step = jax.jit(jax_trainer.build_train_step(
        JaxDBTextModel(dtype=jnp.bfloat16), tx, jcfg))
    state = jax_trainer.TrainState(
        params=v["params"], batch_stats=v["batch_stats"],
        opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    jbatch = {k: jnp.asarray(a) for k, a in T.array_batch(batch).items()}
    with jax.default_matmul_precision("highest"):
        new, loss, _, _ = step(state, jbatch, jnp.float32(LR))
    ref = jax.device_get({"params": new.params, "loss": loss})

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = default_config()
        cfg.optimizer.reduction = "none"
        model = DBTextModel(compute_dtype=dtype)
        model.load_state_dict(state_dict_from_jax(v["params"],
                                                  v["batch_stats"]))
        port_state = T.TrainState(model, T.make_optimizer(cfg, model))
        _, port_loss, _, preds = T.build_train_step(cfg)(
            port_state, T.to_device(batch, torch.device("cpu")), LR)
        params, _ = torch_state_dict_to_flax(
            {n: p.detach() for n, p in model.named_parameters()},
            strict=True)
        out[dtype] = {"loss": [float(x) for x in port_loss],
                      "params": params, "preds": preds}
    return {"ref": ref, "init": v["params"], "port": out[torch.bfloat16],
            "fp32": out[torch.float32]}


def test_bf16_step_losses_match_jax(bf16_step):
    """The five losses within rtol 5e-3 of the JAX bf16 step's (2.5e-3 at
    most on the CPU; the JAX bf16 step lies up to 1.4e-3 from its fp32
    step), and the port's step really ran in bf16: its losses are not its
    fp32 step's, and its maps are float32."""
    ref = [float(x) for x in bf16_step["ref"]["loss"]]
    got, fp32 = bf16_step["port"]["loss"], bf16_step["fp32"]["loss"]
    np.testing.assert_allclose(got, ref, rtol=5e-3)
    assert max(abs(a - b) / abs(b) for a, b in zip(got, fp32)) > 1e-4
    assert bf16_step["port"]["preds"].dtype == torch.float32


def _pre_bn_bias(path: str) -> bool:
    """A conv bias that a train-mode BN follows: its true gradient is 0, so
    Adam's first step moves it by an arbitrary amount in (−lr, lr)."""
    return path.endswith("['bias']") and (
        "['segmentation_body']" in path and "['conv']['bias']" in path
        or path.endswith("conv1']['bias']")
        or path.endswith("deconv1']['bias']"))


def test_bf16_step_updated_params_match_jax(bf16_step):
    """Adam's first step moves each parameter by about ±lr, the sign of its
    gradient, so the updated parameters compare as shares of elements that
    moved as the JAX bf16 step moved them (within lr/10): at least 0.75
    over all leaves but the biases of ``_pre_bn_bias`` and 0.5 in each
    leaf (0.83 and 0.69 on the CPU; the JAX bf16 step against its fp32
    step: 0.87 and 0.77); every leaf within 2·lr + 1e-6 of JAX's, the most
    one step can differ by."""
    ref = bf16_step["ref"]["params"]
    got = bf16_step["port"]["params"]
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    same, total = 0, 0
    for (path, r), g in zip(paths, jax.tree.leaves(got)):
        r, g = np.asarray(r), np.asarray(g)
        name = jax.tree_util.keystr(path)
        assert np.abs(g - r).max() <= 2 * LR + 1e-6, name
        if _pre_bn_bias(name):
            continue
        ok = np.abs(g - r) <= LR / 10
        assert ok.mean() >= 0.5, (name, ok.mean())
        same += ok.sum()
        total += ok.size
    assert same / total >= 0.75, same / total


# ------------------------------------------------- the dtype's choice ----

def test_compute_dtype_choice():
    """As the JAX trainer: bf16 only under ``parallel.compute_dtype:
    bfloat16`` (the default) on an accelerator, here CUDA; fp32 on the CPU
    or under any other value."""
    cfg = default_config()
    assert cfg.parallel.compute_dtype == "bfloat16"
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert T.compute_dtype(cfg, cuda) == torch.bfloat16
    assert T.compute_dtype(cfg, cpu) == torch.float32
    cfg.parallel.compute_dtype = "float32"
    assert T.compute_dtype(cfg, cuda) == torch.float32
    cfg.parallel = None
    assert T.compute_dtype(cfg, cuda) == torch.float32
    assert default_dtype(cuda) == torch.bfloat16
    assert default_dtype(cpu) == torch.float32
    trainer_cfg = default_config()
    trainer_cfg.meta.device = "cpu"
    trainer_cfg.logging.logger_file = None
    trainer = T.Trainer(trainer_cfg)
    assert trainer.compute_dtype == torch.float32
    assert trainer.init_state().model.compute_dtype == torch.float32


def test_load_model_honours_dtype(tmp_path, jax_variables, images):
    """``load_model`` is fp32 on the CPU by default and takes ``dtype``;
    the bf16 model's maps are float32 and lie within the bf16 envelope of
    the fp32 maps."""
    sd = state_dict_from_jax(jax_variables["params"],
                             jax_variables["batch_stats"])
    path = str(tmp_path / "model.pth")
    torch.save(sd, path)
    plain = load_model(path, device="cpu", fuse_head=True)
    assert plain.compute_dtype == torch.float32
    bf16 = load_model(path, device="cpu", fuse_head=True,
                      dtype=torch.bfloat16)
    assert bf16.compute_dtype == torch.bfloat16
    x = torch.from_numpy(images)
    with torch.no_grad():
        a, b = plain(x), bf16(x)
    assert b.dtype == torch.float32
    assert 0 < (a - b).abs().mean().item() < 0.01
