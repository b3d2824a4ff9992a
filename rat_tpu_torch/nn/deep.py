"""Adaptive-parameter-generation (APG) layers and the v2-style MLP block
(port of rat_tpu.nn.deep):

- APGLinear: a linear layer whose weight may be GENERATED per example
  by a hypernetwork, optionally low-rank (U . W_gen . V), with
  over-parameterized factors;
- APGMLPLayer: an MLP whose linear layers take generated weights under
  condition modes none / single / self / moe (experts aggregated by
  mean, sum, max or attention);
- MLPBlock: an MLP with batch_norm OR layer_norm, before or after the
  activation.

A generated weight is applied per example as a batched matrix product.
"""

import torch
from torch import nn

from .initializers import xavier_normal
from .layers import Dropout, MLPLayer, TorchBatchNorm, _per_layer, get_activation, linear


class APGLinear(nn.Module):
    """[B, in] -> [B, out]. With ``is_weight_generated`` the weight comes
    with the call (``weight_tensor`` [B, in out], or [B, r r] with
    ``decompose_rank`` r: then U_matrix maps in -> r and V_matrix r ->
    out, through U_over / V_over of width ``overparam_dim`` when set);
    else it is the parameter ``weight`` [in, out]."""

    def __init__(self, in_features, out_features, use_bias=True, is_weight_generated=False,
                 decompose_rank=None, overparam_dim=None, generator=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.is_weight_generated = is_weight_generated
        self.decompose_rank = decompose_rank
        if not is_weight_generated:
            self.weight = nn.Parameter(xavier_normal(generator,
                                                     (in_features, out_features)))
        elif decompose_rank is not None:
            r = decompose_rank
            if overparam_dim is None:
                self.U_over = self.V_over = None
                self.U_matrix = linear(in_features, r, generator, bias=False)
                self.V_matrix = linear(r, out_features, generator, bias=False)
            else:
                self.U_over = linear(in_features, overparam_dim, generator, bias=False)
                self.U_matrix = linear(overparam_dim, r, generator, bias=False)
                self.V_over = linear(r, overparam_dim, generator, bias=False)
                self.V_matrix = linear(overparam_dim, out_features, generator, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, inp, weight_tensor=None):
        if not self.is_weight_generated:
            out = inp @ self.weight
        else:
            assert weight_tensor is not None
            r = self.decompose_rank
            lead = weight_tensor.shape[:-1]
            if r is None:
                weight = weight_tensor.reshape(*lead, self.in_features, self.out_features)
                out = inp
            else:
                weight = weight_tensor.reshape(*lead, r, r)
                out = self.U_matrix(inp if self.U_over is None else self.U_over(inp))
            out = torch.matmul(out[..., None, :], weight)[..., 0, :]
            if r is not None:
                out = self.V_matrix(out if self.V_over is None else self.V_over(out))
        return out if self.bias is None else out + self.bias


class APGMLPLayer(nn.Module):
    """An MLP of APGLinear layers (``linear_{i}``). Under a condition mode
    other than ``none`` each layer's weight is generated per example by a
    hypernetwork, an :class:`MLPLayer` built from ``meta_net_configs``
    (one dict for every layer, or a list, one per layer): ``hyper_{i}``
    of the ``conditions`` (single) or of the layer's input (self); or, in
    moe, ``num_experts`` experts ``hyper_{i}_expert_{j}`` of
    ``conditions[:, j]``, aggregated by mean, sum, max or attention (a
    query ``hyper_{i}_query`` of the layer's input; experts at or past
    ``condition_lens`` are masked, and a row with none gets zeros)."""

    def __init__(self, input_dim, output_dim=None, hidden_units=(), hidden_activations="relu",
                 output_activation=None, dropout_rates=0., batch_norm=False, use_bias=True,
                 condition_mode="none", decompose_ranks=None, overparam_dims=None,
                 meta_net_configs=None, generator=None):
        super().__init__()
        assert condition_mode in ["none", "single", "moe", "self"]
        self.condition_mode = condition_mode
        units = [input_dim] + list(hidden_units)
        dims = list(zip(units[:-1], units[1:]))
        if output_dim is not None:
            dims.append((units[-1], output_dim))
        self.n_layers, self.n_hidden = len(dims), len(hidden_units)
        ranks = _per_layer(decompose_ranks, self.n_layers)
        overs = _per_layer(overparam_dims, self.n_layers)
        self.acts = [get_activation(a) for a in
                     _per_layer(hidden_activations, self.n_hidden)]
        self.drops = nn.ModuleList(Dropout(p) for p in
                                   _per_layer(dropout_rates, self.n_hidden))
        self.out_act = None if output_activation is None \
            else get_activation(output_activation)
        self.norms = nn.ModuleList(TorchBatchNorm(u) for u in hidden_units) \
            if batch_norm else None
        generated = condition_mode != "none"
        if generated:
            assert meta_net_configs is not None, "conditioning requires meta-net configs"
            if isinstance(meta_net_configs, dict):
                meta_net_configs = [meta_net_configs] * self.n_layers
        self.experts, self.aggregation = [], []
        for idx, (in_f, out_f) in enumerate(dims):
            self.add_module("linear_{}".format(idx), APGLinear(
                in_f, out_f, use_bias=use_bias, is_weight_generated=generated,
                decompose_rank=ranks[idx], overparam_dim=overs[idx], generator=generator))
            if not generated:
                continue
            cfg = dict(meta_net_configs[idx])
            num_experts = cfg.pop("num_experts", 1)
            aggregation = cfg.pop("aggregation", "mean")
            if condition_mode == "moe" and aggregation not in ("attention", "mean", "sum",
                                                               "max"):
                raise NotImplementedError(aggregation)
            if condition_mode == "self":
                cfg["input_dim"] = in_f
            gen_dim = ranks[idx] ** 2 if ranks[idx] is not None else out_f * in_f
            cfg["output_dim"] = gen_dim
            self.experts.append(num_experts)
            self.aggregation.append(aggregation)
            if condition_mode != "moe":
                self.add_module("hyper_{}".format(idx), MLPLayer(generator=generator, **cfg))
                continue
            for i in range(num_experts):
                self.add_module("hyper_{}_expert_{}".format(idx, i),
                                MLPLayer(generator=generator, **cfg))
            if aggregation == "attention":
                self.add_module("hyper_{}_query".format(idx), linear(in_f, gen_dim, generator))

    def _gen_weight(self, idx, outputs, conditions, condition_lens):
        if self.condition_mode != "moe":
            source = outputs if self.condition_mode == "self" else conditions
            return getattr(self, "hyper_{}".format(idx))(source)
        num_experts = self.experts[idx]
        moe = torch.stack([getattr(self, "hyper_{}_expert_{}".format(idx, i))(conditions[:, i])
                           for i in range(num_experts)], dim=-2)        # [B, Ne, gen]
        aggregation = self.aggregation[idx]
        if aggregation == "mean":
            return moe.mean(dim=-2)
        if aggregation == "sum":
            return moe.sum(dim=-2)
        if aggregation == "max":
            return moe.max(dim=-2).values
        query = getattr(self, "hyper_{}_query".format(idx))(outputs)
        w = (query[:, None, :] * moe).sum(dim=-1)                        # [B, Ne]
        if condition_lens is not None:
            mask = (torch.arange(num_experts, device=w.device)[None, :]
                    >= condition_lens[:, None])
            w = torch.where(mask, torch.full_like(w, -float("inf")), w)
        w = torch.nan_to_num(torch.softmax(w, dim=-1))
        return (moe * w[..., None]).sum(dim=-2)

    def forward(self, inputs, conditions=None, condition_lens=None):
        assert inputs.dim() == 2, "Require input shape like [Bxd]"
        outputs = inputs
        for idx in range(self.n_layers):
            lin = getattr(self, "linear_{}".format(idx))
            if self.condition_mode != "none":
                outputs = lin(outputs, weight_tensor=self._gen_weight(
                    idx, outputs, conditions, condition_lens))
            else:
                outputs = lin(outputs)
            if idx < self.n_hidden:
                if self.norms is not None:
                    outputs = self.norms[idx](outputs)
                outputs = self.drops[idx](self.acts[idx](outputs))
        return outputs if self.out_act is None else self.out_act(outputs)


class MLPBlock(nn.Module):
    """FuxiCTR-v2-style MLP: per hidden layer a Linear, then batch_norm
    OR layer_norm before or after the activation
    (``norm_before_activation``), then dropout; an output Linear when
    ``output_dim`` is set, then ``output_activation``."""

    def __init__(self, input_dim, hidden_units=(), hidden_activations="relu", output_dim=None,
                 output_activation=None, dropout_rates=0., batch_norm=False, layer_norm=False,
                 norm_before_activation=True, use_bias=True, generator=None):
        super().__init__()
        self.acts = [get_activation(a) for a in
                     _per_layer(hidden_activations, len(hidden_units))]
        self.drops = nn.ModuleList(Dropout(p) for p in
                                   _per_layer(dropout_rates, len(hidden_units)))
        self.out_act = None if output_activation is None \
            else get_activation(output_activation)
        self.norm_before_activation = norm_before_activation
        dims = [input_dim] + list(hidden_units) + ([] if output_dim is None else [output_dim])
        self.n_hidden = len(hidden_units)
        self.linears = nn.ModuleList(linear(a, b, generator, bias=use_bias)
                                     for a, b in zip(dims, dims[1:]))
        if batch_norm:
            self.norms = nn.ModuleList(TorchBatchNorm(u) for u in hidden_units)
        elif layer_norm:
            self.norms = nn.ModuleList(nn.LayerNorm(u, eps=1e-5) for u in hidden_units)
        else:
            self.norms = None

    def forward(self, x):
        for i in range(self.n_hidden):
            x = self.linears[i](x)
            if self.norms is not None and self.norm_before_activation:
                x = self.norms[i](x)
            x = self.acts[i](x)
            if self.norms is not None and not self.norm_before_activation:
                x = self.norms[i](x)
            x = self.drops[i](x)
        if len(self.linears) > self.n_hidden:
            x = self.linears[-1](x)
        return x if self.out_act is None else self.out_act(x)
