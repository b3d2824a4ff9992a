"""RAT_m2 as KKBox_x1's published configuration runs it
(configs/RAT_m2/kkbox_x1), in plain PyTorch: sequence fields, BatchNorm
in the DNN tower and embedding dropout, with the model's loss and the
training step of its published trainer. It extends :mod:`rat` (the
grid, the encoder blocks, the CLS head, the clip and Adam as there) by
import:

- Fields. A categorical field embeds its id's row. A sequence field
  (``dataset.sequences``: ``max_len`` id columns, padded with the id
  vocab - 1) embeds the sum of its ids' rows, a padding id adding
  nothing (FuxiCTR's MaskedSumPooling). Each field's rows are its part
  of one table of all fields, in field order.
- Embedding dropout (``emb_dropout``). In training the grid [B, 1 + K,
  F + 1, d] (the label token and the fields) goes through dropout
  before the encoder: a kept value is scaled by 1 / (1 - p), a dropped
  one is 0. The DNN and the wide tower read the embeddings before it.
- DNN: per hidden layer a Linear, BatchNorm1d (eps 1e-5, momentum 0.1)
  and relu, then a Linear to the logit, over the target's F x d field
  embeddings. BatchNorm is torch's ``F.batch_norm``: in training the
  batch's mean and biased variance, and the running mean and running
  unbiased variance moved by the momentum; in evaluation the running
  statistics.
- Wide tower: one learned scalar per id value, summed over every id of
  the target row (a sequence's padding adds nothing).
- Loss: torch's binary cross-entropy (each log clamped at -100, finite
  at a prediction of 0 or 1), the mean over the batch, plus (lambda /
  2) times the squared norm of every embedding table.

Departures from the published description, each one of the benchmark's
making:

- The dropout mask of each training step is an input, handed in with
  the batch: the mask that the program under test drew, so that the
  reference follows its steps. A mask drawn here would be another draw.
- The padding id's row is a row like the others, drawn with the table
  and decayed by the regularizer; the mask, not the row, makes it add
  nothing. (FuxiCTR keeps a padding row at zero and gives it no
  gradient; what the model computes is the same.)
- BatchNorm's parameters and running statistics are named as the
  program names them (``dnn.norms.<j>.``), so that one state dict
  serves both.
"""

import torch
import torch.nn.functional as F

from . import rat
from .rat import ONES, ZEROS

#: the state dict's entries that are buffers: BatchNorm's statistics
BUFFERS = ("running_mean", "running_var")
#: BatchNorm's settings (torch's BatchNorm1d defaults, FuxiCTR's)
BN_MOMENTUM, BN_EPS = 0.1, 1e-5


def is_buffer(name):
    return name.endswith(BUFFERS)


def param_spec(cfg, vocab):
    """[(name, shape, kind)] of every parameter and buffer of the model,
    under the names of the program's state dict."""
    if cfg["dropout"] or cfg["net_dropout"]:
        raise NotImplementedError("the reference drops the embeddings alone")
    spec = rat.param_spec(dict(cfg, batch_norm=False, emb_dropout=0.0), vocab)
    if cfg["batch_norm"]:
        for j, units in enumerate(cfg["dnn_hidden_units"]):
            p = "dnn.norms.{}.".format(j)
            spec += [(p + "weight", (units,), ONES), (p + "bias", (units,), ZEROS),
                     (p + "running_mean", (units,), ZEROS),
                     (p + "running_var", (units,), ONES)]
    return spec


class Layout(object):
    """Where each id column of a row lies: ``offsets`` [C], the first
    row of its field in the one table; ``pads`` [C], a sequence
    column's padding id (vocab - 1), -1 for a categorical column; and
    ``spans``, each field's (first column, width), in field order."""

    def __init__(self, cfg, vocab, device):
        seqs = cfg["dataset"]["sequences"]
        offsets, pads, self.spans = [], [], []
        row = col = 0
        for name, size in vocab.items():
            width = 1
            if name in seqs:
                if seqs[name]["encoder"] != "MaskedSumPooling":
                    raise NotImplementedError(seqs[name]["encoder"])
                width = seqs[name]["max_len"]
            offsets += [row] * width
            pads += [size - 1 if name in seqs else -1] * width
            self.spans.append((col, width))
            row += size
            col += width
        self.offsets = torch.tensor(offsets, dtype=torch.int64, device=device)
        self.pads = torch.tensor(pads, dtype=torch.int64, device=device)


def embed(table, ids, layout):
    """[..., F, w] field embeddings of ``ids`` [..., C] from ``table``."""
    vecs = table[ids + layout.offsets]
    vecs = vecs * (ids != layout.pads)[..., None].to(vecs.dtype)
    return torch.stack([vecs[..., c:c + n, :].sum(dim=-2) for c, n in layout.spans], dim=-2)


def logits(w, ids, labels, cfg, layout, mask=None):
    """[B] logits. ``ids`` [B, 1 + K, C] the id columns of the target
    (slot 0) and its neighbours, ``labels`` [B, 1 + K] (slot 0 unused).
    ``mask`` [B, 1 + K, F + 1, d] bool, the embedding dropout's kept
    values, makes it a training step (BatchNorm on the batch's
    statistics, its running ones moved in ``w``); None, evaluation."""
    B = ids.shape[0]
    training = mask is not None
    emb = embed(w["embedding_layer.table"], ids, layout)               # [B, T, F, d]
    lab = torch.cat([torch.full((B, 1), 2, dtype=torch.int64, device=ids.device),
                     labels[:, 1:].to(torch.int64)], dim=1)
    x = torch.cat([w["label_embedding_layer.table"][lab][:, :, None, :], emb], dim=2)
    if training and cfg["emb_dropout"]:
        x = torch.where(mask, x / (1 - cfg["emb_dropout"]), torch.zeros_like(x))
    for i in range(cfg["depth"]):
        x = rat._block(x, w, "encoder.blocks.{}.".format(i), cfg)
    out = x[:, 0, 0] @ w["fc.weight"].t() + w["fc.bias"]
    h = emb[:, 0].reshape(B, -1)
    n_lin = len(cfg["dnn_hidden_units"]) + 1
    for j in range(n_lin):
        h = h @ w["dnn.linears.{}.weight".format(j)].t() + w["dnn.linears.{}.bias".format(j)]
        if j < n_lin - 1:
            if cfg["batch_norm"]:
                p = "dnn.norms.{}.".format(j)
                h = F.batch_norm(h, w[p + "running_mean"], w[p + "running_var"],
                                 w[p + "weight"], w[p + "bias"], training=training,
                                 momentum=BN_MOMENTUM, eps=BN_EPS)
            h = torch.relu(h)
    out = out + h
    if cfg["use_wide"]:
        wide = embed(w["lr_layer.embedding_layer.table"], ids[:, :1], layout)
        out = out + wide.sum(dim=(1, 2, 3))[:, None]
    return out[:, 0]


def loss(w, ids, labels, cfg, layout, mask):
    """A training step's loss: the batch's mean binary cross-entropy
    plus the embedding regularizer."""
    p = torch.sigmoid(logits(w, ids, labels, cfg, layout, mask))
    total = F.binary_cross_entropy(p, labels[:, 0].to(p.dtype))
    lam = cfg["embedding_regularizer"]
    for name, t in w.items():
        if "embedding_layer" in name and lam:
            total = total + (lam / 2) * torch.sum(t * t)
    return total


def train_steps(w0, batches, masks, cfg, layout, dtype=torch.float32, adam=None):
    """The published step over ``batches`` [(ids, labels), ...] with the
    dropout ``masks`` (one per batch), from the state dict ``w0``, every
    tensor in ``dtype``; ``adam`` as in :func:`rat.train_steps`. Returns
    (losses, the first step's gradient as Adam gets it {name: tensor},
    the state after the last step {name: tensor}, BatchNorm's running
    statistics included)."""
    w = {n: t.detach().to(dtype).clone() for n, t in w0.items()}
    names = [n for n in w if not is_buffer(n)]
    for n in names:
        w[n].requires_grad_()
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
    for (ids, labels), mask in zip(batches, masks):
        value = loss(w, ids, labels, cfg, layout, mask)
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
def predict(w, ids, labels, cfg, layout, dtype=torch.float32, block=8192):
    """[B] click probabilities in evaluation, ``block`` rows at a time."""
    wd = {n: t.to(dtype) for n, t in w.items()}
    out = [torch.sigmoid(logits(wd, ids[lo:lo + block], labels[lo:lo + block], cfg,
                                layout)).to(torch.float32)
           for lo in range(0, len(ids), block)]
    return torch.cat(out)
