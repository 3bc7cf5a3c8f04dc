"""Faults planted in the program underneath a run, for the tests that
see ``correct`` come out false: each is a function that patches the
port's engine in the calling process."""

import torch

from cognn_tpu_torch.mpc import engine as mpc_engine


def state_unchanged():
    """An epoch computes its weights and metrics but keeps the old
    weights."""
    def step(self):
        return (self._epoch_unopt() if self.unopt else self._epoch_opt())[1]
    mpc_engine.MpcGasEngine._epoch_step = step


def half_batch():
    """Each party's gradient over the first half of its training rows,
    the mean taken over that half."""
    init = mpc_engine.MpcGasEngine.__init__

    def patched(self, plan, param, *args, **kw):
        init(self, plan, param, *args, **kw)
        mask = self.arr.train_mask
        rank = torch.cumsum(mask.to(torch.int64), dim=-1)
        half = (mask.sum(-1, keepdim=True) // 2).clamp(min=1)
        self.arr.train_mask = mask & (rank <= half)
        self.inv_train_fp = self.proto.encode_public(
            1.0 / half[:, 0].to(torch.float32))
    mpc_engine.MpcGasEngine.__init__ = patched


def answer_altered():
    """A served answer's logits changed where they are revealed."""
    body = mpc_engine.MpcGasEngine._forward_body

    def patched(self):
        z, prob, metrics = body(self)
        z = z.clone()
        z[0, 0] += 1.0
        return z, prob, metrics
    mpc_engine.MpcGasEngine._forward_body = patched

