"""Known-bad: a graph kept alive past its step — the differentiated loss
stored on ``self``, and a tensor kept on an ``autograd.Function`` ctx as
an attribute instead of ``save_for_backward``.

Lines carrying ``EXPECT: <rule>`` markers are the golden findings
tests/test_torch_analysis.py asserts, line-exact."""

import torch


class Trainer:
    def step(self, batch):
        loss = self.model(batch).sum()
        loss.backward()
        self.last_loss = loss  # EXPECT: autograd-leak
        return float(loss.detach())


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.x = x  # EXPECT: autograd-leak
        ctx.save_for_backward(w)
        return x * w

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g * w, g * ctx.x
