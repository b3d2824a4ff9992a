"""Optimizer construction and regularizer parsing (port of
rat_tpu.engine.optim).

Semantics, as in the JAX package:

- Adam with torch defaults (betas 0.9/0.999, eps 1e-8, bias-corrected,
  no weight decay), which are optax.adam's;
- adamw, sgd, adagrad and rmsprop written to optax's update rules with
  optax's defaults (``OptaxRule``), not torch.optim's, whose differ:
  adamw decays weights by 1e-4 inside the scaled update, adagrad starts
  its accumulators at 0.1 with eps 1e-7 inside the root, rmsprop decays
  by 0.9 with eps inside the root, sgd has no momentum;
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
  LR-on-plateau schedule can decay it without rebuilding the state, as
  ``optax.inject_hyperparams`` lets the JAX package.
"""

import torch


def clip_grad_global_norm(params, max_norm, sq_norm=None):
    """Scale the gradients of ``params`` in place by ``max_norm / norm``
    when their global norm is at least ``max_norm`` (optax's formula).
    ``sq_norm(params)``, when given, returns the squared global norm (a
    mesh sums the sharded tables' squares over its model group); by
    default it is the sum of every gradient's squares. Stays on the
    device: no host sync. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return None
    norm = torch.sqrt(sq_norm(params) if sq_norm is not None
                      else sum((g * g).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class OptaxRule(torch.optim.Optimizer):
    """One of optax's optimizers at its defaults, as the update
    ``params += -lr * u`` with u:

    - ``sgd``: the gradient g;
    - ``adagrad``: t = g^2 + t (t from 0.1), u = g / sqrt(t + 1e-7)
      (0 where t is 0);
    - ``rmsprop``: nu = 0.1 g^2 + 0.9 nu (nu from 0), u = g / sqrt(nu + 1e-8);
    - ``adamw``: Adam's bias-corrected mu_hat / (sqrt(nu_hat) + 1e-8)
      (betas 0.9/0.999) plus 1e-4 times the parameter.
    """

    NAMES = ("adamw", "sgd", "adagrad", "rmsprop")

    def __init__(self, params, name, lr):
        if name not in self.NAMES:
            raise ValueError("optimizer={} is not an optax rule here".format(name))
        super().__init__(params, {"lr": lr})
        self.name = name

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxRule.step takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.add_(self._update(p, p.grad, self.state[p]) * -group["lr"])

    def _update(self, p, g, state):
        if self.name == "sgd":
            return g
        if self.name == "adagrad":
            if not state:
                state["sum_of_squares"] = torch.full_like(p, 0.1)
            t = state["sum_of_squares"]
            t.copy_(g * g + t)
            return torch.where(t > 0, torch.rsqrt(t + 1e-7), 0.0) * g
        if self.name == "rmsprop":
            if not state:
                state["nu"] = torch.zeros_like(p)
            nu = state["nu"]
            nu.copy_((1 - 0.9) * (g * g) + 0.9 * nu)
            return torch.rsqrt(nu + 1e-8) * g
        b1, b2 = 0.9, 0.999
        if not state:
            state.update(count=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
        state["count"] += 1
        mu, nu, count = state["mu"], state["nu"], state["count"]
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        mu_hat = mu / (1 - b1 ** count)
        nu_hat = nu / (1 - b2 ** count)
        return mu_hat / (torch.sqrt(nu_hat) + 1e-8) + 1e-4 * p


def get_optimizer(optimizer, params, lr, max_gradient_norm=10., grad_sq_norm=None):
    """``adam`` (``torch.optim.Adam``, whose formula and defaults are
    optax.adam's) or one of :class:`OptaxRule`'s over ``params``; with
    ``max_gradient_norm`` above 0, every ``step()`` first clips the
    gradients of all its parameters to that global norm
    (``grad_sq_norm`` as :func:`clip_grad_global_norm`'s ``sq_norm``)."""
    name = optimizer.lower() if isinstance(optimizer, str) else None
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=0.0)
    elif name in OptaxRule.NAMES:
        opt = OptaxRule(params, name, lr)
    else:
        raise NotImplementedError("optimizer={} is not supported.".format(optimizer))
    if max_gradient_norm is not None and max_gradient_norm > 0:
        def clip(o, args, kwargs):
            clip_grad_global_norm([p for g in o.param_groups for p in g["params"]],
                                  max_gradient_norm, grad_sq_norm)
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
