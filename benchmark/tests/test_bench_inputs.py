"""Every input is made from the seed: one seed gives the same inputs, another
gives other inputs, for each traffic generator."""

import torch

from benchmark import inputs
from benchmark.generators import train
from benchmark.tests.helpers import config

CPU = torch.device("cpu")
SEEDS = (2**31 + 5, 2**31 + 5, 17)


def same_and_other(make):
    a, b, c = (make(s) for s in SEEDS)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert any(x.shape == z.shape and not torch.equal(x, z) for x, z in zip(a, c))


def test_weights_body_scenes():
    cfg = config("psi_s1", "genfit")
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "bn.weight": (4,), "bn.running_mean": (4,)}

    def make(s):
        w = inputs.fill_weights(shapes, inputs.generator(s, 1, CPU), CPU)
        b = inputs.make_body(cfg, inputs.generator(s, 3, CPU), CPU)
        sc = inputs.make_scenes(cfg, inputs.generator(s, 4, CPU), CPU)
        return [w[k] for k in sorted(w)] + [b["posedirs"], b["contact"], sc["sdf"], sc["cloud"]]

    same_and_other(make)


def test_genfit_pool():
    cfg = config("psi_s1", "genfit")

    def make(s):
        sn = inputs.make_snapshots(4, 32, 2, inputs.generator(s, 5, CPU), CPU)
        return [sn["xs"], sn["cam_int"], inputs.latents("s1", 16, inputs.generator(s, 6, CPU), CPU)]

    same_and_other(make)
    assert inputs.latents("s2", 8, inputs.generator(3, 6, CPU), CPU)[0].shape == (8, 32)


def test_train_pack():
    cfg = config("psi_s1", "train")

    def make(s):
        p = train.make_pack_arrays(8, cfg, inputs.generator(s, 5, CPU), CPU)
        return [torch.from_numpy(p[k]) for k in sorted(p)]

    same_and_other(make)


def test_training_start_weights():
    """The program's start of a training run: kernels and their biases
    uniform within 1/sqrt(fan_in) of the kernel, BatchNorm at identity."""
    shapes = {"a.weight": (4, 3, 3, 3), "a.bias": (4,), "bn.weight": (4,), "bn.bias": (4,), "bn.running_mean": (4,),
              "bn.running_var": (4,), "bn.num_batches_tracked": ()}

    def make(s):
        w = inputs.training_start(shapes, inputs.generator(s, 1, CPU), CPU)
        return [w["a.weight"], w["a.bias"]]

    same_and_other(make)
    w = inputs.training_start(shapes, inputs.generator(3, 1, CPU), CPU)
    bound = 1 / 27**0.5
    assert float(w["a.weight"].abs().max()) <= bound and float(w["a.bias"].abs().max()) <= bound
    assert float(w["a.weight"].abs().max()) > 0.8 * bound
    assert torch.equal(w["bn.weight"], torch.ones(4)) and torch.equal(w["bn.running_var"], torch.ones(4))
    assert not w["bn.bias"].any() and not w["bn.running_mean"].any() and w["bn.num_batches_tracked"].dtype == torch.int64
