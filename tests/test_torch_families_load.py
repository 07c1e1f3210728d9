"""The port's other detector families at their edges, against the JAX
package on the CPU: the seeded init (deformable and depthwise kernels,
zero offsets) against flax's in distribution, the torchvision-keyed
backbone ``.pth``, structured pruning, and a flax-mode ``.pt2`` export of
deformable_resnet18. Helpers in ``torch_families``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.models.deform import DeformConv as JaxDeformConv
from db_text_minimal_tpu.models.fpn import SeparableConv2d
from db_text_minimal_tpu.models.prune import \
    prune_dbnet_variables as jax_prune
from db_text_minimal_tpu.utils.torch_port import load_pretrained_backbone
from db_text_minimal_tpu_torch.config import default_config
from db_text_minimal_tpu_torch.models import DBTextModel
from db_text_minimal_tpu_torch.models import prune as P
from db_text_minimal_tpu_torch.models.resnet import BACKBONES
from db_text_minimal_tpu_torch.serve.export import (export_model,
                                                    load_exported)
from db_text_minimal_tpu_torch.train import trainer as T
from db_text_minimal_tpu_torch.utils import CAFFE_MEAN
from db_text_minimal_tpu_torch.weights import state_dict_from_jax
from torch_families import SIZE, np_tree, random_variables, zeros_input

torch.set_num_threads(1)


def _flax_init(module, x):
    return np_tree(jax.jit(lambda k: module.init(k, x))(
        jax.random.PRNGKey(0)))["params"]


def _same_distribution(got: torch.Tensor, ref: np.ndarray, what: str):
    """Mean 0 within 4 standard errors; std within 4 standard errors of
    flax's sample std plus 1 %."""
    a = got.double().flatten()
    b = torch.from_numpy(np.asarray(ref, np.float64)).flatten()
    assert abs(a.mean()) < 4 * a.std() / a.numel() ** 0.5, what
    se = b.std() * (2 / a.numel()) ** 0.5
    assert abs(a.std() - b.std()) < 4 * se + 0.01 * b.std(), what


def test_init_matches_flax_in_distribution():
    """The port's seeded init of deformable_resnet18 + FPEM_FFM against
    flax's init of the same modules: every deformable kernel (F, C, 3, 3)
    Kaiming-normal by flax's fan-out 9 · F, every depthwise kernel
    (C, 1, 3, 3) by 9 · C, the offset branches and the conv biases zero."""
    model = DBTextModel(backbone_name="deformable_resnet18",
                        neck_name="FPEM_FFM")
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    deform = [k for k in sd if k.endswith("conv2.weight")
              and "layer1" not in k]
    depthwise = [k for k in sd if k.endswith("depthwise_conv.weight")]
    assert len(deform) == 6 and len(depthwise) == 12
    for key in deform:
        f, c = sd[key].shape[:2]
        ref = _flax_init(JaxDeformConv(f), jnp.zeros((1, 4, 4, c)))
        _same_distribution(sd[key], ref["kernel"], key)
        assert not np.asarray(ref["offset_conv"]["kernel"]).any()
        for leaf in ("weight", "bias"):
            assert not sd[key.replace("weight",
                                      f"offset_conv.{leaf}")].any(), key
    ref = _flax_init(SeparableConv2d(128), jnp.zeros((1, 4, 4, 128)))
    for key in depthwise:
        _same_distribution(sd[key], ref["depthwise_conv"]["kernel"], key)
        assert not sd[key.replace("weight", "bias")].any(), key


@pytest.mark.parametrize("name", ["resnet50", "deformable_resnet50"])
def test_torchvision_backbone_load(name, tmp_path):
    """A torchvision-keyed ResNet-50 ``.pth`` (no ``backbone.`` prefix, its
    ``fc`` head, no offset branches) warm-starts the Trainer's backbone as
    the JAX ``load_pretrained_backbone`` merge does: the same weights, a
    deformable backbone's 13 offset branches left at zero. A key the
    backbone lacks still raises."""
    sd = dict(BACKBONES["resnet50"]().state_dict())
    sd["fc.weight"] = torch.zeros(10, 2048)
    sd["fc.bias"] = torch.zeros(10)
    path = str(tmp_path / f"{name}.pth")
    torch.save(sd, path)
    cfg = default_config()
    cfg.meta.device = "cpu"
    cfg.meta.root_dir = str(tmp_path)
    cfg.logging.logger_file = None
    cfg.model.backbone = name
    cfg.model.pretrained_backbone_path = path
    got = T.Trainer(cfg).init_state().model.backbone.state_dict()

    params, stats = random_variables(JaxDBTextModel(backbone_name=name),
                                     zeros_input(), offset_scale=0.0)
    params, stats = load_pretrained_backbone(path, params, stats)
    ref = state_dict_from_jax({"backbone": params["backbone"]},
                              {"backbone": stats["backbone"]})
    for key, value in ref.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(
                got[key[len("backbone."):]].numpy(), value.numpy(),
                err_msg=key)
    offsets = [k for k in got if "offset_conv" in k]
    assert len(offsets) == (26 if name.startswith("deformable") else 0)
    assert all(not got[k].any() for k in offsets)

    sd["layer9.0.conv1.weight"] = torch.zeros(1)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="layer9"):
        T.Trainer(cfg).init_state()


@pytest.mark.parametrize("backbone,neck", [
    ("resnet50", "FPN"), ("deformable_resnet18", "FPN"),
    ("resnet18", "FPEM_FFM")])
def test_prune_new_families_as_jax(backbone, neck):
    """``prune_dbnet_variables`` does what JAX's does on a Bottleneck, a
    deformable and an FPEM_FFM model: the same widths and weights (the
    Bottleneck and deformable blocks and the FPEM_FFM neck left whole),
    and the pruned model loads at its widths."""
    params, stats = random_variables(
        JaxDBTextModel(backbone_name=backbone, neck_name=neck),
        zeros_input())
    keeps = {"backbone_keep": 0.5, "fpn_inner_keep": 0.75,
             "fpn_out_keep": 0.5}
    ref, ref_widths = jax_prune({"params": params, "batch_stats": stats},
                                **keeps)
    got, widths = P.prune_dbnet_variables(
        state_dict_from_jax(params, stats), **keeps)
    assert widths == ref_widths
    want = state_dict_from_jax(ref["params"], ref["batch_stats"])
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    DBTextModel(backbone_name=backbone, neck_name=neck,
                **P.widths_to_model_kwargs(widths)).load_state_dict(
                    got, strict=True)
    if neck == "FPEM_FFM":
        assert set(widths) == {"backbone_hidden"}


def test_flax_export_of_deformable_resnet18(tmp_path):
    """A flax-mode ``.pt2`` of deformable_resnet18 + FPN (the gather
    ``DeformConv`` in the graph; uint8 input, the means subtracted in it)
    equals the live forward on the CPU, offsets off the grid."""
    model = DBTextModel(backbone_name="deformable_resnet18")
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "offset_conv" in name:
                p.normal_(0, 0.01, generator=torch.Generator().manual_seed(1))
    model.eval()
    path = export_model(model, str(tmp_path / "db.pt2"),
                        input_shape=(2, SIZE, SIZE, 3), device="cpu")
    infer = load_exported(path, device="cpu")
    x = np.random.RandomState(1).randint(0, 256, (2, SIZE, SIZE, 3),
                                         dtype=np.uint8)
    with torch.no_grad():
        live = model(torch.from_numpy(
            x.astype(np.float32) - np.asarray(CAFFE_MEAN, np.float32)))
    np.testing.assert_allclose(infer(x).numpy(), live.numpy(), rtol=0,
                               atol=1e-5)
