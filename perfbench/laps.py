"""Set-up's parts, timed on the host clock."""

import time

import torch


class Laps:
    """Seconds of each part of set-up, each ended when the card is done."""

    def __init__(self, device):
        self.device, self.parts, self.t = device, {}, time.perf_counter()

    def __call__(self, name):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.parts[name] = t - self.t
        self.t = t
