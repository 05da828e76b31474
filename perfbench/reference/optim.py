"""GANtron's optimizer, plain: clip the gradients by their global norm
(scaled by max_norm / norm only when norm >= max_norm), add weight_decay *
param, then Adam (0.9, 0.999, eps 1e-8, bias-corrected), step -lr."""

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def global_norm(tensors):
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class Adam:
    def __init__(self, params, clip, weight_decay):
        self.clip, self.wd, self.count = clip, weight_decay, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    def resume(self, count, m, v):
        """Continue from another optimizer's state: its update count and
        moments (copied onto the parameters' device)."""
        self.count = count
        self.m = [x.to(p.device, copy=True) for x, p in zip(m, self.m)]
        self.v = [x.to(p.device, copy=True) for x, p in zip(v, self.v)]

    @torch.no_grad()
    def step(self, params, grads, lr):
        """Updates ``params`` in place; returns the gradients as the
        moments took them (after the clip and the weight decay)."""
        if self.clip > 0:
            norm = global_norm(grads)
            if norm >= self.clip:
                grads = [g / norm * self.clip for g in grads]
        grads = [g + self.wd * p for g, p in zip(grads, params)]
        self.count += 1
        bc1, bc2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(B1).add_((1 - B1) * g)
            v.mul_(B2).add_((1 - B2) * g * g)
            p.add_(-lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS))
        return grads
