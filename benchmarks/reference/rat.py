"""RAT_m2 (Retrieval-Augmented Transformer, WWW 2024) in plain PyTorch:
its parameters, forward, loss and the training step of its published
trainer (fuxictr's BaseModel with the RAT repo's settings).

- Grid: for each example, the target row and its K retrieved rows, each
  the label token (neighbours: their 0/1 label; the target: the mask id
  2) followed by the F field embeddings: [B, 1 + K, F + 1, d]. A field's
  table is its rows of the one table of all fields, in field order.
- Block (depth times): attention over the F + 1 tokens of each sample,
  then over the 1 + K samples of each token position, each pre-LayerNorm
  (eps 1e-5) with a residual; then a feed-forward (Linear, exact GELU,
  Linear) with a residual and no pre-norm. Attention: one bias-free QKV
  projection, softmax of q.k scaled by dim_head ** -0.5 per head, and an
  output projection with bias unless heads == 1 and dim_head == d.
- Logit: a Linear on the CLS token (the target's label token after the
  encoder) + a relu MLP on the target's F x d embedding + the wide
  (LR) tower: the sum of one learned scalar per field value of the
  target row. Prediction: its sigmoid.
- Loss: binary cross-entropy (torch's, as the published trainer takes
  it: each log clamped at -100, and a finite gradient where a
  prediction reaches 0 or 1), the mean over the batch, plus (lambda / 2) times the squared norm of every
  embedding table (the names holding "embedding_layer").
- Step: the gradient's global norm clipped to ``max_gradient_norm``
  (scaled by max / norm where the norm reaches it), then Adam (0.9,
  0.999, eps 1e-8, bias-corrected).

A neighbour slot that retrieval dropped (-1) takes the pool's last row,
as the published data loader's index does.
"""

import numpy as np
import torch
import torch.nn.functional as F

#: parameter kinds: how the benchmark draws each one's first values
EMBEDDING, LABEL, XAVIER, ONES, ZEROS = "embedding", "label", "xavier", "ones", "zeros"


def param_spec(cfg, vocab):
    """[(name, shape, kind)] of every parameter of the model, under the
    names of the program's state dict."""
    if cfg["batch_norm"] or any(cfg[k] for k in ("dropout", "emb_dropout", "net_dropout")):
        raise NotImplementedError("the reference has no BatchNorm and no dropout")
    d, h, dh = cfg["embedding_dim"], cfg["num_heads"], cfg["dim_head"]
    n_fields, rows = len(vocab), sum(vocab.values())
    inner, hidden = h * dh, d * cfg["scale_dim"]
    project_out = not (h == 1 and dh == d)
    spec = [("embedding_layer.table", (rows, d), EMBEDDING),
            ("label_embedding_layer.table", (3, d), LABEL),
            ("query_proj_kernel", (d * n_fields, d * n_fields), XAVIER),
            ("query_proj_bias", (d * n_fields,), ZEROS)]
    for i in range(cfg["depth"]):
        b = "encoder.blocks.{}.".format(i)
        for part in ("intra_attention", "cross_attention"):
            p = b + part + "."
            spec += [(p + "norm.weight", (d,), ONES), (p + "norm.bias", (d,), ZEROS),
                     (p + "attn.to_qkv.weight", (3 * inner, d), XAVIER)]
            if project_out:
                spec += [(p + "attn.to_out.weight", (d, inner), XAVIER),
                         (p + "attn.to_out.bias", (d,), ZEROS)]
        spec += [(b + "mlp.fc1.weight", (hidden, d), XAVIER),
                 (b + "mlp.fc1.bias", (hidden,), ZEROS),
                 (b + "mlp.fc2.weight", (d, hidden), XAVIER),
                 (b + "mlp.fc2.bias", (d,), ZEROS)]
    spec += [("fc.weight", (1, d), XAVIER), ("fc.bias", (1,), ZEROS)]
    dims = [n_fields * d] + list(cfg["dnn_hidden_units"]) + [1]
    for j, (a, o) in enumerate(zip(dims, dims[1:])):
        spec += [("dnn.linears.{}.weight".format(j), (o, a), XAVIER),
                 ("dnn.linears.{}.bias".format(j), (o,), ZEROS)]
    if cfg["use_wide"]:
        spec.append(("lr_layer.embedding_layer.table", (rows, 1), EMBEDDING))
    return spec


def field_offsets(vocab, device):
    """[F] first row of each field's table in the one table."""
    sizes = np.array(list(vocab.values()), np.int64)
    return torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)[:-1]])).to(device)


def _attention(x, w, p, heads, dim_head, project_out):
    n, L, d = x.shape
    x = F.layer_norm(x, (d,), w[p + "norm.weight"], w[p + "norm.bias"], 1e-5)
    q, k, v = (x @ w[p + "attn.to_qkv.weight"].t()).chunk(3, dim=-1)
    q, k, v = (t.reshape(n, L, heads, dim_head).transpose(1, 2) for t in (q, k, v))
    a = torch.softmax((q @ k.transpose(-1, -2)) * dim_head ** -0.5, dim=-1) @ v
    a = a.transpose(1, 2).reshape(n, L, heads * dim_head)
    if project_out:
        a = a @ w[p + "attn.to_out.weight"].t() + w[p + "attn.to_out.bias"]
    return a


def _block(x, w, p, cfg):
    b, t, s, d = x.shape
    h, dh = cfg["num_heads"], cfg["dim_head"]
    po = not (h == 1 and dh == d)
    y = x.reshape(b * t, s, d)
    y = _attention(y, w, p + "intra_attention.", h, dh, po) + y
    y = y.reshape(b, t, s, d).transpose(1, 2).reshape(b * s, t, d)
    y = _attention(y, w, p + "cross_attention.", h, dh, po) + y
    ff = F.gelu(y @ w[p + "mlp.fc1.weight"].t() + w[p + "mlp.fc1.bias"], approximate="none")
    y = ff @ w[p + "mlp.fc2.weight"].t() + w[p + "mlp.fc2.bias"] + y
    return y.reshape(b, s, t, d).transpose(1, 2)


def logits(w, ids, labels, cfg, offsets):
    """[B] logits. ``ids`` [B, 1 + K, F] field-local ids of the target
    (slot 0) and its neighbours, ``labels`` [B, 1 + K] (slot 0 unused)."""
    B, T, n_fields = ids.shape
    d = cfg["embedding_dim"]
    rows = ids + offsets
    emb = w["embedding_layer.table"][rows]                              # [B, T, F, d]
    lab = torch.cat([torch.full((B, 1), 2, dtype=torch.int64, device=ids.device),
                     labels[:, 1:].to(torch.int64)], dim=1)
    x = torch.cat([w["label_embedding_layer.table"][lab][:, :, None, :], emb], dim=2)
    for i in range(cfg["depth"]):
        x = _block(x, w, "encoder.blocks.{}.".format(i), cfg)
    out = x[:, 0, 0] @ w["fc.weight"].t() + w["fc.bias"]
    h = emb[:, 0].reshape(B, n_fields * d)
    n_lin = len(cfg["dnn_hidden_units"]) + 1
    for j in range(n_lin):
        h = h @ w["dnn.linears.{}.weight".format(j)].t() + w["dnn.linears.{}.bias".format(j)]
        if j < n_lin - 1:
            h = torch.relu(h)
    out = out + h
    if cfg["use_wide"]:
        out = out + w["lr_layer.embedding_layer.table"][rows[:, 0]].sum(dim=(1, 2))[:, None]
    return out[:, 0]


def loss(w, ids, labels, cfg, offsets):
    """The batch's mean binary cross-entropy plus the embedding
    regularizer."""
    p = torch.sigmoid(logits(w, ids, labels, cfg, offsets))
    total = F.binary_cross_entropy(p, labels[:, 0].to(p.dtype))
    lam = cfg["embedding_regularizer"]
    for name, t in w.items():
        if "embedding_layer" in name and lam:
            total = total + (lam / 2) * torch.sum(t * t)
    return total


def train_steps(w0, batches, cfg, offsets, dtype=torch.float32, adam=None):
    """Run the published step over ``batches`` [(ids, labels), ...] from
    the weights ``w0``, every tensor in ``dtype``. ``adam`` = (first
    moments, second moments, steps taken, learning rate), each but the
    rate a {name: value}, continues an optimizer's state; by default Adam
    starts afresh at the configuration's rate. Returns (losses, the first
    step's gradient as Adam gets it {name: tensor}, the weights after the
    last step {name: tensor}); a parameter the loss does not reach gets
    no gradient and is not moved."""
    w = {n: t.detach().to(dtype).clone().requires_grad_() for n, t in w0.items()}
    names = list(w)
    m = {n: torch.zeros_like(w[n]) for n in names}
    v = {n: torch.zeros_like(w[n]) for n in names}
    taken = {n: 0 for n in names}
    lr = cfg["learning_rate"]
    if adam is not None:
        m0, v0, taken0, lr = adam
        for n in m0:
            m[n], v[n], taken[n] = m0[n].to(dtype).clone(), v0[n].to(dtype).clone(), taken0[n]
    b1, b2, eps = 0.9, 0.999, 1e-8
    max_norm = cfg["max_gradient_norm"]
    losses, first = [], None
    for ids, labels in batches:
        value = loss(w, ids, labels, cfg, offsets)
        grads = torch.autograd.grad(value, [w[n] for n in names], allow_unused=True)
        grads = {n: g for n, g in zip(names, grads) if g is not None}
        norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads.values()))
        if norm >= max_norm:
            grads = {n: g * (max_norm / norm).to(dtype) for n, g in grads.items()}
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        with torch.no_grad():
            for n, g in grads.items():
                taken[n] += 1
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[n] / (1 - b1 ** taken[n])
                v_hat = v[n] / (1 - b2 ** taken[n])
                w[n].sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
        losses.append(float(value.detach()))
    return losses, first, {n: t.detach() for n, t in w.items()}


@torch.no_grad()
def predict(w, ids, labels, cfg, offsets, dtype=torch.float32, block=8192):
    """[B] click probabilities, ``block`` rows at a time."""
    wd = {n: t.to(dtype) for n, t in w.items()}
    out = [torch.sigmoid(logits(wd, ids[lo:lo + block], labels[lo:lo + block], cfg,
                                offsets)).to(torch.float32)
           for lo in range(0, len(ids), block)]
    return torch.cat(out)
