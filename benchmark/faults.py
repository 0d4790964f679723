"""Faults planted in the program under the timed path, for the check of
``correct``: each has to make a run come out not correct. Used by the CPU
tests (``tests/test_bench_correct.py``) and by ``calibrate --faults`` on the
card at the cells' own sizes.

* unchanged_state: the optimizer returns its state as it got it;
* half_batch: half of the batch is left out and the mean taken over the rest
  (a fit: every other body of the population takes no gradient);
* altered_answer: an answer is altered where it is produced (body 0 of every
  sampled population moved by 0.5 m in height; every training step's
  update nudged by 1e-3 in each element of one leaf).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

NAMES = ("unchanged_state", "half_batch", "altered_answer")


@contextlib.contextmanager
def _patched(obj, name: str, value) -> Iterator[None]:
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def plant(fault: str, generator: str):
    """A context manager that plants ``fault`` for a cell whose traffic
    generator is ``generator`` ('genfit' or 'train')."""
    if fault == "unchanged_state":
        if generator == "train":
            import psi_tpu_torch.train.loop as loop

            class Still(torch.optim.Adam):
                def step(self, closure=None):
                    return None

            return _patched(loop, "make_optimizer", lambda m, lr: Still(m.parameters(), lr=lr))
        import psi_tpu_torch.fit.fitting as fitting

        return _patched(fitting.Adam, "step", lambda self, x, g: x)
    if fault == "half_batch":
        if generator == "train":
            import psi_tpu_torch.train.loop as loop

            inner = loop.cvae_loss

            def halved(model, batch, *a, eps=None, **k):
                h = eps.shape[0] // 2
                return inner(model, {n: v[:h] for n, v in batch.items()}, *a, eps=eps[:h], **k)

            return _patched(loop, "cvae_loss", halved)
        import psi_tpu_torch.fit.fitting as fitting

        inner_l = fitting._per_body_losses

        def half_loss(assets, xhr, *a, **k):
            total, rest = inner_l(assets, xhr, *a, **k)
            per = rest[0]["total"]
            return per[::2].sum() * (per.shape[0] / per[::2].shape[0]), rest

        return _patched(fitting, "_per_body_losses", half_loss)
    if fault == "altered_answer":
        if generator == "train":
            import psi_tpu_torch.train.loop as loop

            inner_o = loop.make_optimizer

            def nudged(model, lr):
                opt = inner_o(model, lr)
                step = opt.step
                leaf = dict(model.named_parameters())["linear_out.bias"]

                def stepped(closure=None):
                    out = step(closure)
                    with torch.no_grad():
                        leaf.add_(1e-3)
                    return out

                opt.step = stepped
                return opt

            return _patched(loop, "make_optimizer", nudged)
        import psi_tpu_torch.fit.fitting as fitting

        inner_g = fitting.generate_bodies

        def sampled(*a, **k):
            x72 = inner_g(*a, **k)
            return torch.cat([x72[:1] + 0.5 * (torch.arange(72, device=x72.device) == 1), x72[1:]])

        return _patched(fitting, "generate_bodies", sampled)
    raise ValueError(f"unknown fault {fault!r}")
