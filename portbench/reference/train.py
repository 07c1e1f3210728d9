"""Plain PyTorch DB training step: the DB loss (OHEM-balanced BCE with the
top-k negatives, dice on B̂, masked L1 on T) and Adam, float32.

From DBNet (arXiv:1911.08947 §3.3: L = L_s + α·L_b + β·L_t with α = 1,
β = 10, OHEM at 3 negatives a positive) as the configuration states it,
with no code of the measured program. The k hardest negatives are summed
through ``torch.topk``.
"""

from __future__ import annotations

import torch

from . import model as M

BCE_EPS = 1e-7
EPS = 1e-6


def db_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
            thresh_gt: torch.Tensor, thresh_mask: torch.Tensor,
            loss_cfg: dict) -> torch.Tensor:
    """pred (N, 3, H, W) = (P, T, B̂); maps (N, H, W) float32."""
    p, t, b = pred[:, 0], pred[:, 1], pred[:, 2]
    pos = gt * mask
    neg = (1.0 - gt) * mask
    n_pos = pos.sum()
    n_neg = torch.minimum(n_pos * loss_cfg["negative_ratio"], neg.sum())
    pc = p.clamp(BCE_EPS, 1.0 - BCE_EPS)
    bce = -(gt * torch.log(pc) + (1.0 - gt) * torch.log(1.0 - pc))
    k = int(n_neg.item())
    neg_sum = (torch.topk((bce * neg).reshape(-1), k).values.sum() if k > 0
               else bce.sum() * 0.0)
    prob_loss = ((bce * pos).sum() + neg_sum) / (n_pos + n_neg + EPS)
    l1 = ((t - thresh_gt).abs() * thresh_mask).sum() / (thresh_mask.sum()
                                                        + EPS)
    dice = 1.0 - 2.0 * (b * gt * mask).sum() / ((b * mask).sum()
                                                + (gt * mask).sum() + EPS)
    return (loss_cfg["alpha"] * dice + prob_loss + loss_cfg["beta"] * l1)


class Adam:
    """Adam (Kingma & Ba) without weight decay, the update written out."""

    def __init__(self, params: dict, opt_cfg: dict):
        self.lr = opt_cfg["lr"]
        self.b1, self.b2 = opt_cfg["betas"]
        self.eps = opt_cfg["eps"]
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (self.m[k] / c1)
                   / ((self.v[k] / c2).sqrt() + self.eps))


def trainable(spec: list) -> list[str]:
    """The names of the trained parameters (norm statistics excluded)."""
    return [name for name, _, kind in spec
            if kind not in ("bn_mean", "bn_var", "bn_count")]


def images_to_input(img_u8: torch.Tensor, mean) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW less the per-channel means."""
    x = img_u8.float() - torch.tensor(mean, dtype=torch.float32,
                                      device=img_u8.device)
    return x.permute(0, 3, 1, 2).contiguous()


def run_steps(weights: dict, spec: list, cfg: dict, batches: list,
              ops: M.Ops, remat: bool = True) -> dict:
    """Trains a copy of ``weights`` one step on each of ``batches`` (dicts
    of device tensors: ``x`` (N, 3, H, W) float32 and the four float32 GT
    maps) and returns the readings the check compares: ``losses`` (one a
    step), ``grad_norms`` (each parameter's gradient norm at step 1) and
    ``update_norms`` (each parameter's change after the last step)."""
    names = trainable(spec)
    params = {k: weights[k].detach().clone().float() for k in names}
    fixed = {k: v for k, v in weights.items() if k not in params}
    start = {k: v.clone() for k, v in params.items()}
    opt = Adam(params, cfg["optimizer"])
    losses, grad_norms = [], None
    for i, b in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        pred = M.forward({**fixed, **leaves}, b["x"], cfg, ops, train=True,
                         remat=remat)
        loss = db_loss(pred, b["prob_map"], b["supervision_mask"],
                       b["thresh_map"], b["text_area_map"], cfg["loss"])
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        grads = dict(zip(names, grads))
        losses.append(float(loss.detach()))
        if i == 0:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        del pred, loss, leaves
        opt.step(params, grads)
        del grads
    update_norms = {k: float((params[k] - start[k]).norm()) for k in names}
    return {"losses": losses, "grad_norms": grad_norms,
            "update_norms": update_norms}
