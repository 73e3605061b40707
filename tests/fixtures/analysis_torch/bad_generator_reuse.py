"""Known-bad: a generator re-seeded every call (or every iteration with a
seed the loop does not vary) restarts its stream; the sampler's
counter-based draws give the same bits for one (key, position).

Lines carrying ``EXPECT: <rule>`` markers are the golden findings
tests/test_torch_analysis.py asserts, line-exact."""

import torch

from hpc_patterns_tpu_torch.models.decode import gumbel_noise


class Sampler:
    def draw(self, n):
        self.gen.manual_seed(0)  # EXPECT: generator-reuse
        return torch.rand(n, generator=self.gen)


def loop_reseed(gen, n):
    out = []
    for _ in range(n):
        gen.manual_seed(1234)  # EXPECT: generator-reuse
        out.append(torch.rand(1, generator=gen))
    return out


def two_draws(logits, keys, pos):
    a = gumbel_noise(keys, pos, logits.shape[-1])
    b = gumbel_noise(keys, pos, logits.shape[-1])  # EXPECT: generator-reuse
    return logits + a + b
