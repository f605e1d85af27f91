"""The port's lr schedulers (mxnet_tpu_torch/lr_scheduler.py) against the
JAX package's: every scheduler, with a linear and a constant warm-up and
without one, at every update count 0-1200, within 1e-12 relative (both
are plain Python doubles); the argument check of FactorScheduler; and
the optimizer's ``learning_rate`` following its scheduler from
``base_lr``, the optimizer's own learning rate."""
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CASES = {
    "factor": ("FactorScheduler", dict(step=100, factor=0.7,
                                       stop_factor_lr=1e-3)),
    "multifactor": ("MultiFactorScheduler", dict(step=[450, 150, 900],
                                                 factor=0.3)),
    "poly": ("PolyScheduler", dict(max_update=1000, pwr=2, final_lr=1e-4)),
    "poly1": ("PolyScheduler", dict(max_update=1000, pwr=1)),
    "cosine": ("CosineScheduler", dict(max_update=1000, final_lr=2e-3)),
}
WARMUPS = {"none": {},
           "linear": dict(warmup_steps=50, warmup_begin_lr=1e-3),
           "constant": dict(warmup_steps=50, warmup_mode="constant")}


@pytest.mark.parametrize("warmup", sorted(WARMUPS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_schedules_match_jax(case, warmup):
    cls, kw = CASES[case]
    kw = dict(kw, base_lr=0.1, **WARMUPS[warmup])
    want = getattr(jmx.lr_scheduler, cls)(**kw)
    got = getattr(tmx.lr_scheduler, cls)(**kw)
    for t in range(1201):
        assert got(t) == pytest.approx(want(t), rel=1e-12, abs=0), t


def test_optimizer_follows_its_scheduler():
    with pytest.raises(MXNetError, match="step must be >= 1"):
        tmx.lr_scheduler.FactorScheduler(step=0)
    for pkg in (jmx, tmx):
        sched = pkg.lr_scheduler.PolyScheduler(max_update=100, base_lr=9.0,
                                               warmup_steps=10)
        opt = pkg.optimizer.create("lamb", learning_rate=0.5,
                                   lr_scheduler=sched)
        assert sched.base_lr == 0.5
        opt.num_update = 40
        assert opt.learning_rate == sched(40)
    with pytest.raises(NotImplementedError):
        tmx.lr_scheduler.LRScheduler()(3)
