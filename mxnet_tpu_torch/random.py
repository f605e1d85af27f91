"""``mx.random`` seeding and dropout bits (counterpart of
``mxnet_tpu/random.py`` and ``_rng.py``).

The JAX package threads stateless keys; the port draws from explicit
``torch.Generator`` objects instead: one per device, seeded by
:func:`seed`, that the dropout sites draw from unless a caller passes its
own ``generator=``. The same seed gives different numbers in the two
packages (threefry vs. Philox / Mersenne Twister), so tests that compare
them make their inputs, and their dropout bits, with numpy.

Dropout draws one uint8 per element (:func:`bits`, the counterpart of
``jax.random.bits(key, shape, jnp.uint8)``) and keeps where the bits are
at least ``keep_threshold(p)``. :func:`bits_tape` records the bits a
forward draws, or hands recorded bits back in the same order, so one
forward on the card and one on the CPU can use the same masks;
:func:`kept_bits` keeps what a forward drew, so that a recompute of it
(``ShardedTrainer(remat=)``) can hand the same bits back. :func:`draws`
lets a CUDA-graph capture see which generators a forward
draws from and which tensors it draws into (see
``gluon/cached_graph.py``).

The samplers (``uniform``, ``normal``, ``randn``, ``gamma``, ...) are
``mx.nd.random``'s: each draws from the device's generator
(:func:`sampler_generator`), which :func:`draws` notes like a dropout
draw, so a CUDA-graph capture registers it and ``seed`` reproduces the
values. They cannot equal the JAX package's (threefry against Philox).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["bernoulli", "bits", "bits_tape", "device_generator", "draws",
           "exponential", "gamma", "generalized_negative_binomial",
           "generator", "kept_bits", "multinomial", "negative_binomial",
           "normal", "poisson", "randint", "randn", "sampler_generator",
           "seed", "shuffle", "uniform"]

_lock = threading.Lock()
_seed = 0
_generators: dict = {}          # torch.device -> torch.Generator
_tape = threading.local()


def generator(seed_state: int, device="cpu") -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with
    ``seed_state`` — what initializers and tests draw from. Drawing on
    the CPU generator and copying to the card gives the same weights on
    every device."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed_state))
    return g


def seed(seed_state: int) -> None:
    """ref: mx.random.seed — seeds PyTorch's default generators (which
    initializers use when they are given no generator) and every
    device's dropout generator."""
    global _seed
    torch.manual_seed(int(seed_state))
    with _lock:
        _seed = int(seed_state)
        for g in _generators.values():
            g.manual_seed(_seed)


def device_generator(device) -> torch.Generator:
    """The dropout generator of ``device``, made at first use and seeded
    with the last :func:`seed` (0 before any)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        g = _generators.get(device)
        if g is None:
            g = _generators[device] = generator(_seed, device)
        return g


def bits(shape, device, generator=None) -> torch.Tensor:
    """uint8 random bits of ``shape`` on ``device``, drawn from
    ``generator`` (the device's dropout generator when None) — or, inside
    :func:`bits_tape` with recorded bits, the next recorded tensor."""
    out = _draw(shape, device, generator)
    kept = getattr(_tape, "kept", None)
    if kept is not None:
        kept.append(out)
    return out


def sampler_generator(device) -> torch.Generator:
    """The generator an ``mx.nd`` sampler draws from on ``device``: the
    device's generator, noted in an active :func:`draws` scope (its state
    kept before the first draw) as :func:`bits` notes it."""
    g = device_generator(device)
    seen = getattr(_tape, "draws", None)
    if seen is not None and seen.keep_states and g not in seen.states:
        seen.states[g] = g.get_state()
    return g


def _draw(shape, device, generator):
    tape = getattr(_tape, "active", None)
    if tape is not None and tape.replay is not None:
        out = tape.replay[tape.pos].to(device)
        tape.pos += 1
        if tuple(out.shape) != tuple(shape) or out.dtype != torch.uint8:
            raise ValueError(f"recorded bits {tuple(out.shape)} "
                             f"{out.dtype} do not fit a draw of "
                             f"{tuple(shape)} uint8")
        return out
    g = device_generator(device) if generator is None else generator
    seen = getattr(_tape, "draws", None)
    if seen is not None and seen.keep_states and g not in seen.states:
        seen.states[g] = g.get_state()
    out = torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                        device=device, generator=g)
    if tape is not None:
        tape.drawn.append(out)
    if seen is not None:
        seen.drawn.append(out)
    return out


class _Tape:
    def __init__(self, replay):
        self.replay = None if replay is None else list(replay)
        self.pos = 0
        self.drawn = []


@contextlib.contextmanager
def bits_tape(replay=None):
    """Within the scope, every :func:`bits` draw is recorded in
    ``tape.drawn``; with ``replay`` (a list of uint8 tensors, e.g. an
    earlier tape's ``drawn``) the draws return those tensors in order,
    moved to the drawing device, instead."""
    prev = getattr(_tape, "active", None)
    _tape.active = tape = _Tape(replay)
    try:
        yield tape
    finally:
        _tape.active = prev


@contextlib.contextmanager
def kept_bits(into):
    """Within the scope, every :func:`bits` result on this thread, drawn
    or handed back by a replaying tape, is also appended to the list
    ``into``, which :func:`bits_tape` can replay."""
    prev = getattr(_tape, "kept", None)
    _tape.kept = into
    try:
        yield into
    finally:
        _tape.kept = prev


def replaying() -> bool:
    """True inside :func:`bits_tape` with recorded bits to hand back."""
    tape = getattr(_tape, "active", None)
    return tape is not None and tape.replay is not None


def record_drawn(tensors) -> None:
    """Append ``tensors`` to the recording :func:`bits_tape` of this
    thread, if one is active: a CUDA graph's static bits after a replay,
    which hold that replay's draws."""
    tape = getattr(_tape, "active", None)
    if tape is not None and tape.replay is None:
        tape.drawn.extend(tensors)


class _Draws:
    def __init__(self, keep_states):
        self.keep_states = keep_states
        self.states = {}          # generator -> state before its first draw
        self.drawn = []           # the tensors drawn, in order


@contextlib.contextmanager
def draws(keep_states=True):
    """Within the scope, :func:`bits` lists every draw on this thread:
    ``seen.drawn`` (the tensors, in order) and, with ``keep_states``,
    ``seen.states`` (each generator drawn from, with its state before
    its first draw, to restore it). A :func:`bits_tape` of an enclosing
    scope is suspended meanwhile."""
    prev = getattr(_tape, "active", None), getattr(_tape, "draws", None)
    seen = _Draws(keep_states)
    _tape.active, _tape.draws = None, seen
    try:
        yield seen
    finally:
        _tape.active, _tape.draws = prev


def _nd_random():
    from .ndarray import random as nd_random
    return nd_random


def uniform(*args, **kwargs):
    """ref: mx.random.uniform — ``mx.nd.random.uniform``."""
    return _nd_random().uniform(*args, **kwargs)


def normal(*args, **kwargs):
    """ref: mx.random.normal — ``mx.nd.random.normal``."""
    return _nd_random().normal(*args, **kwargs)


def randn(*shape, loc=0.0, scale=1.0, **kwargs):
    """ref: mx.random.randn(*shape) — positional arguments are the
    shape."""
    return _nd_random().normal(loc=loc, scale=scale, shape=shape or (1,),
                               **kwargs)


def gamma(*args, **kwargs):
    return _nd_random().gamma(*args, **kwargs)


def exponential(*args, **kwargs):
    return _nd_random().exponential(*args, **kwargs)


def poisson(*args, **kwargs):
    return _nd_random().poisson(*args, **kwargs)


def negative_binomial(*args, **kwargs):
    return _nd_random().negative_binomial(*args, **kwargs)


def generalized_negative_binomial(*args, **kwargs):
    return _nd_random().generalized_negative_binomial(*args, **kwargs)


def randint(*args, **kwargs):
    return _nd_random().randint(*args, **kwargs)


def multinomial(*args, **kwargs):
    return _nd_random().multinomial(*args, **kwargs)


def shuffle(*args, **kwargs):
    return _nd_random().shuffle(*args, **kwargs)


def bernoulli(*args, **kwargs):
    return _nd_random().bernoulli(*args, **kwargs)
