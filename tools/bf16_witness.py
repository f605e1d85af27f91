#!/usr/bin/env python3
"""How far the port's bf16 ``ShardedTrainer`` update lies from the JAX
package's, measured against bf16 rounding itself (CPU).

Run from the root of a checkout:

    JAX_PLATFORMS=cpu python3 tools/bf16_witness.py [--no-excess-precision]

For the narrow ResNet V1 (SGD momentum) and the narrow BERT MLM (Adam)
of ``tests/test_torch_sharded.py``, with fp32 and with bf16 masters,
three bf16 steps run in both packages, each from the JAX package's
state, beside a witness: the JAX package's fp32 step from the same
state. Per step it prints, over the model's trainable weights:

- ``port-jax/|dj|``: ||port update - JAX bf16 update|| / ||JAX bf16 update||;
- ``port-jax/rounding``: the same distance over ||JAX bf16 update -
  JAX fp32 update||, in norm and, element by element, max over max;
- ``el port-jax``, ``el jax-fp32``: the max elementwise differences
  over the fp32 update's max |change|.

``--no-excess-precision`` sets ``XLA_FLAGS=--xla_allow_excess_precision=
false`` before JAX starts, so XLA rounds a fused elementwise chain to
bf16 after each op, as PyTorch does.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-excess-precision", action="store_true")
    args = parser.parse_args()
    if args.no_excess_precision:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_allow_excess_precision=false")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import numpy as np
    from test_torch_sharded import (_carry, _jax_state, _port_state,
                                    _restart, _trainers, _update)

    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    for model in ("resnet", "bert"):
        for master in (None, "bfloat16"):
            jtr, ttr, batch = _trainers(model, "bfloat16", master)
            witness = _trainers(model)[0]
            for tr in (jtr, ttr, witness):
                tr.prepare(*batch[:-1])
            for step in range(3):
                start = _jax_state(jtr)
                _restart(witness, jtr)
                jl = float(jtr.step(*batch).asnumpy())
                tl = float(ttr.step(*batch))
                witness.step(*batch)
                dj, dt, df = (_update(s, start) for s in (
                    _jax_state(jtr), _port_state(ttr), _jax_state(witness)))
                apart = np.linalg.norm(dt - dj)
                rounding = np.linalg.norm(dj - df)
                top = np.abs(df).max()
                print(f"{model} masters {master or 'float32'} step {step}: "
                      f"loss rel {abs(tl - jl) / abs(jl):.3e}; "
                      f"port-jax/|dj| {apart / np.linalg.norm(dj):.3f}; "
                      f"port-jax/rounding norm {apart / rounding:.3f}, "
                      f"elementwise {np.abs(dt - dj).max() / np.abs(dj - df).max():.3f}; "
                      f"el port-jax {np.abs(dt - dj).max() / top:.3f}, "
                      f"el jax-fp32 {np.abs(dj - df).max() / top:.3f}",
                      flush=True)
                _carry(jtr, ttr)


if __name__ == "__main__":
    main()
