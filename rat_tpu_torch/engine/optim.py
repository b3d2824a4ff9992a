"""Optimizer construction and regularizer parsing (port of
rat_tpu.engine.optim).

Semantics, as in the JAX package:

- Adam with torch defaults (betas 0.9/0.999, eps 1e-8, bias-corrected,
  no weight decay), which are optax.adam's;
- global-norm gradient clipping BEFORE the update, to optax's
  ``clip_by_global_norm`` formula: with ``norm = sqrt(sum ||g||^2)``
  over every gradient, each gradient is scaled by ``max_norm / norm``
  only when ``norm >= max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
- regularizers are LOSS TERMS ``(lambda/p) * ||w||_p^p``, coupled into
  Adam's moments, split embedding-vs-net by parameter name: any name
  containing "embedding_layer" is an embedding parameter
  (``embedding_layer.table``, ``label_embedding_layer.table`` and
  ``lr_layer.embedding_layer.table``);
- the learning rate lives in the optimizer's ``param_groups``, so the
  LR-on-plateau schedule can decay it without rebuilding Adam's state.

Only Adam is ported: optax's other optimizers have defaults that differ
from torch's (adagrad's initial accumulator, rmsprop's decay, adamw's
weight decay).
"""

import torch


def clip_grad_global_norm(params, max_norm):
    """Scale the gradients of ``params`` in place by ``max_norm / norm``
    when their global norm is at least ``max_norm`` (optax's formula).
    Stays on the device: no host sync. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return None
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def get_optimizer(optimizer, params, lr, max_gradient_norm=10.):
    """``torch.optim.Adam`` over ``params``; with ``max_gradient_norm``
    above 0, every ``step()`` first clips the gradients of all its
    parameters to that global norm."""
    if not isinstance(optimizer, str) or optimizer.lower() != "adam":
        raise NotImplementedError("optimizer={} is not supported.".format(optimizer))
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0)
    if max_gradient_norm is not None and max_gradient_norm > 0:
        def clip(o, args, kwargs):
            clip_grad_global_norm([p for g in o.param_groups for p in g["params"]],
                                  max_gradient_norm)
        opt.register_step_pre_hook(clip)
    return opt


def set_learning_rate(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def get_learning_rate(optimizer):
    return float(optimizer.param_groups[0]["lr"])


def get_regularizer(reg):
    """Parse 'l2(1.e-4)' / 'l1_l2(a,b)' / float -> [(p_norm, weight)]."""
    reg_pair = []
    if isinstance(reg, (int, float)):
        if reg != 0:
            reg_pair.append((2, float(reg)))
    elif isinstance(reg, str):
        try:
            if reg.startswith("l1(") or reg.startswith("l2("):
                reg_pair.append((int(reg[1]), float(reg.rstrip(")").split("(")[-1])))
            elif reg.startswith("l1_l2"):
                l1_reg, l2_reg = reg.rstrip(")").split("(")[-1].split(",")
                reg_pair.append((1, float(l1_reg)))
                reg_pair.append((2, float(l2_reg)))
            else:
                raise NotImplementedError
        except (NotImplementedError, ValueError, IndexError):
            raise NotImplementedError("regularizer={} is not supported.".format(reg))
    elif reg is not None:
        raise NotImplementedError("regularizer={} is not supported.".format(reg))
    return reg_pair


def is_embedding_param(name):
    """The reference's substring test on the parameter's name."""
    return "embedding_layer" in name


def regularization_loss(named_params, embedding_reg, net_reg):
    """Sum over ``(name, w)`` of ``(lambda/p) * ||w||_p^p``, split by
    name. Returns 0.0 when neither regularizer is set."""
    emb_pairs = get_regularizer(embedding_reg)
    net_pairs = get_regularizer(net_reg)
    total = 0.0
    if not emb_pairs and not net_pairs:
        return total
    for name, w in named_params:
        one = 0.0
        for p, lam in (emb_pairs if is_embedding_param(name) else net_pairs):
            if p == 2:
                one = one + (lam / 2) * torch.sum(w * w)
            elif p == 1:
                one = one + lam * torch.sum(torch.abs(w))
            else:
                one = one + (lam / p) * torch.sum(torch.abs(w) ** p)
        total = total + one
    return total
