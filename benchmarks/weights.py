"""The model's first weights, made from the seed on the device in a few
large calls: one normal draw for every drawn parameter, cut and scaled
per leaf. The kinds follow the published initialisation: embedding
tables N(0, ``embedding_std``) (1e-4 in the RAT repo), the label table
N(0, 1), Xavier-normal matrices, LayerNorm scales 1, biases 0."""

import math

import torch

from .reference import rat


def make(spec, seed, device, embedding_std):
    """{name: float32 tensor} for ``spec`` [(name, shape, kind)]."""
    drawn = [(n, s, k) for n, s, k in spec if k not in (rat.ONES, rat.ZEROS)]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, lo = {}, 0
    for name, shape, kind in spec:
        if kind == rat.ONES:
            out[name] = torch.ones(shape, device=device)
            continue
        if kind == rat.ZEROS:
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        t = flat[lo:lo + n].view(shape)
        lo += n
        if kind == rat.EMBEDDING:
            t = t * embedding_std
        elif kind == rat.XAVIER:
            fan_out, fan_in = (shape[0], shape[1]) if len(shape) == 2 else (shape[0], shape[0])
            t = t * math.sqrt(2.0 / (fan_in + fan_out))
        out[name] = t.contiguous()
    return out
