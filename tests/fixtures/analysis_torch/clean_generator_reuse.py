"""Known-clean: a generator made and seeded where it is used, a seed the
loop varies, one draw per (key, position), and a scorer handed the
noise it was drawn with."""

import torch

from hpc_patterns_tpu_torch.models.decode import (
    fold_keys,
    gumbel_noise,
    sample_scores,
)


def draw(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(n, generator=gen)


def per_trial(gen, n):
    out = []
    for i in range(n):
        gen.manual_seed(1234 + i)
        out.append(torch.rand(1, generator=gen))
    return out


def scored(logits, keys, pos, temps):
    g = gumbel_noise(keys, pos, logits.shape[-1])
    g2 = gumbel_noise(fold_keys(keys, 1), pos, logits.shape[-1])
    return sample_scores(logits, keys, pos, temps, 0, g), g2
