"""Running meters (reference: utils/meters.py:4-31)."""


class AverageMeter:
    def __init__(self, momentum: float = 0.998):
        self.momentum = momentum
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.moving_avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        m = min(self.momentum, 1.0 - 1.0 / max(self.count, 1))
        self.moving_avg = self.moving_avg * m + val * (1 - m)
