"""The PyTorch port's DB losses against the JAX package on the CPU: the same
maps, made from a seed with numpy, through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu import losses as JL
from db_text_minimal_tpu_torch import losses as L

torch.set_num_threads(1)

RTOL = 1e-5   # f32 sums over 8192 pixels, taken in another order


@pytest.fixture(scope="module")
def maps():
    rs = np.random.RandomState(0)
    shape = (2, 64, 64)
    preds = rs.rand(*shape, 3).astype(np.float32)
    preds[0, :3, :3, 0] = [0.0, 1.0, 1e-9]     # the BCE clip at 1e-7
    return {"preds": preds,
            "prob_gt": (rs.rand(*shape) > 0.7).astype(np.float32),
            "mask": (rs.rand(*shape) > 0.1).astype(np.float32),
            "thresh_gt": (rs.rand(*shape) * 0.4 + 0.3).astype(np.float32),
            "text_area": (rs.rand(*shape) > 0.5).astype(np.float32)}


def _both(fn_jax, fn_port, *arrays, **kwargs):
    ref = fn_jax(*(jnp.asarray(a) for a in arrays), **kwargs)
    got = fn_port(*(torch.from_numpy(a) for a in arrays), **kwargs)
    return ref, got


def test_bce_matches_jax(maps):
    ref, got = _both(JL._bce, L._bce, maps["preds"][..., 0], maps["prob_gt"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_ohem_balance_bce_matches_jax(maps, reduction):
    ref, got = _both(JL.ohem_balance_bce, L.ohem_balance_bce,
                     maps["preds"][..., 0], maps["prob_gt"], maps["mask"],
                     reduction=reduction)
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def test_dice_and_masked_l1_match_jax(maps):
    ref, got = _both(JL.dice_loss, L.dice_loss, maps["preds"][..., 2],
                     maps["prob_gt"], maps["mask"])
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)
    ref, got = _both(JL.masked_l1_loss, L.masked_l1_loss,
                     maps["preds"][..., 1], maps["thresh_gt"],
                     maps["text_area"])
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_db_loss_and_eval_loss_match_jax(maps, reduction):
    args = (maps["preds"], maps["prob_gt"], maps["mask"], maps["thresh_gt"],
            maps["text_area"])
    ref, got = _both(JL.db_loss, L.db_loss, *args, reduction=reduction)
    assert isinstance(got, L.DBLossOutput) and got._fields == ref._fields
    for name in ref._fields:
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=RTOL,
                                   err_msg=name)
    args = (maps["preds"][..., :2],) + args[1:]
    ref, got = _both(JL.db_loss_eval, L.db_loss_eval, *args,
                     reduction=reduction)
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


@pytest.mark.parametrize("values,k,expected", [
    # ties at the threshold: top 7 = three 0.9 and four of the ten 0.5
    ([0.5] * 10 + [0.2] * 5 + [0.9] * 3, 7.0, 0.9 * 3 + 0.5 * 4),
    # k = 0 selects nothing
    ([0.5, 0.25, 3.0], 0.0, 0.0),
    # all entries, and a k past the count of non-zero ones
    ([0.0, 0.0, 0.75, 0.5], 3.0, 1.25),
    ([2.0, 4.0, 8.0], 3.0, 14.0),
])
def test_topk_sum_matches_jax(values, k, expected):
    v = np.asarray(values, np.float32)
    ref = JL._topk_sum(jnp.asarray(v), jnp.float32(k))
    got = L._topk_sum(torch.from_numpy(v), torch.tensor(k))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)
    np.testing.assert_allclose(float(got), expected, rtol=RTOL, atol=1e-6)


def test_topk_sum_gradient_selects_the_top_entries():
    v = torch.tensor([0.5, 0.9, 0.1, 0.7, 0.3], requires_grad=True)
    L._topk_sum(v, torch.tensor(2.0)).backward()
    assert v.grad.tolist() == [0.0, 1.0, 0.0, 1.0, 0.0]
