"""Known-clean: a detached loss kept, a loss stored under no_grad, and
forward's tensors kept with save_for_backward (options on ctx are
fine)."""

import torch


class Trainer:
    def step(self, batch):
        loss = self.model(batch).sum()
        loss.backward()
        self.last_loss = loss.detach()
        with torch.no_grad():
            self.shadow = loss
        return float(self.last_loss)


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        ctx.opts = dict(scaled=True)
        return x * w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return g * w, g * x
