#!/usr/bin/env python3
"""Compare the port's CUDA kernels with those of another checkout (the
parent commit) on one card.

Run from the root of a checkout, with the other one unpacked beside it
(``git archive <commit> | tar -x -C DIR``):

    python3 tools/parent_compare.py DIR

Both checkouts' kernels are built afresh into a directory of their own
(``build/compare`` under each root), each by its own ``_build`` in a
separate process. Then:

1. ``ptxas``: every instance of the flash-attention kernels that both
   builds compile, side by side: registers, stack and spill bytes, and
   the dynamic shared memory of one CTA from each library's own size
   query; one line says whether every instance of the backward
   (``flash_attention_bwd_*``) is the same in all four.
2. ``K2 bits``: the matmul-epilogue library of each checkout, called
   through its C interface on the same inputs (every dtype, activation
   and bias mode, with and without dropout bits, on shapes that take the
   vector pass and shapes that take the element pass: a C that is not a
   multiple of the vector, a view at an odd element offset): the outputs
   must be equal bit for bit.
3. ``K2 times``: the 24 launches of a BERT-base MLM training forward in
   bf16 at batch 64, S 128 (ffn_1 bias + gelu, ffn_2 bias + dropout 0.1)
   and the 25 of a BERT-base predict forward in fp32 at batch 8, S 128,
   each checkout's library in turns (other, this, this, other), timed as
   ``chip_smoke.py`` times a kernel (CUDA graphs of back-to-back launches
   over enough input copies to exceed the L2), beside the bytes bound.

Exits non-zero if the K2 outputs differ or a backward instance changed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("flash_attention", "flash_attention_bwd", "matmul_epilogue")

_BUILD = """
import json, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from mxnet_tpu_torch.kernels import _build
_build.BUILD_DIR = Path(sys.argv[1]) / "build" / "compare"
names = sys.argv[2].split(",")
outs = _build.build_all(names)
print(json.dumps({n: [str(_build._target(n)), outs.get(n, "")]
                  for n in names}))
"""


def build(*roots):
    """[{name: (library path, nvcc output)}] of each checkout, built afresh,
    all at once."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, root,
                               ",".join(NAMES)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for root in roots]
    built = []
    for root, proc in zip(roots, procs):
        out, err = proc.communicate(timeout=1800)
        if proc.returncode != 0:
            sys.exit(f"build of {root} failed:\n{out}\n{err}")
        built.append(json.loads(out.strip().splitlines()[-1]))
    return built


def smem_query(lib_path, which):
    lib = ctypes.CDLL(lib_path)
    if which == "fwd":
        fn = lib.flash_attention_smem_bytes
        fn.argtypes = [ctypes.c_int] * 2
    else:
        fn = lib.flash_attention_bwd_smem_bytes
        fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn


def compare_ptxas(chip_smoke, other, this):
    """Print each flash-attention instance of both builds; returns whether
    every backward instance is unchanged."""
    rows = {}
    for tag, built in (("other", other), ("this", this)):
        found, warnings = chip_smoke.ptxas_instances(
            {n: built[n][1] for n in NAMES})
        fwd = smem_query(built["flash_attention"][0], "fwd")
        bwd = smem_query(built["flash_attention_bwd"][0], "bwd")
        for line in warnings:
            print(f"ptxas warning ({tag}): {line}")
        for key, info in found.items():
            which, _, dt, dp, _ = key
            code = chip_smoke._FA_DTYPES[dt][1]
            smem = fwd(code, int(dp)) if which in ("", "fwd_") else bwd(
                0 if which == "bwd_dkv_" else 1, code, int(dp))
            rows.setdefault(key, {})[tag] = (info.get("regs"),
                                             info.get("stack"),
                                             info.get("spills"), smem)
    same_bwd = True
    for key in sorted(rows):
        which, design, dt, dp, causal = key
        a, b = rows[key].get("other"), rows[key].get("this")
        verdict = "same" if a == b else "differs"
        if which.startswith("bwd") and a != b:
            same_bwd = False
        print(f"ptxas: flash_attention_{which}{design}kernel<"
              f"{chip_smoke._FA_DTYPES[dt][0]}, D {dp}, causal {causal}>: "
              f"other {a}, this {b} (registers, stack, spill-store bytes, "
              f"shared memory): {verdict}")
    n_bwd = sum(1 for k in rows if k[0].startswith("bwd"))
    print(f"ptxas: {n_bwd} backward instances, every one the same in "
          f"registers, stack, spills and shared memory: {same_bwd}")
    return same_bwd


def k2_fn(lib_path, root):
    """The launch function of one checkout's K2 library, and whether it
    takes the bias's own dtype code (the sources since the bias is read
    at its own precision)."""
    lib = ctypes.CDLL(lib_path)
    src = Path(root) / "mxnet_tpu_torch" / "kernels" / "csrc" \
        / "matmul_epilogue.cu"
    bias_code = "int bias_dtype" in src.read_text()
    fn = lib.matmul_epilogue_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_int] * (5 if bias_code else 4) \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, bias_code


def k2_call(torch, fn, y, bias, bits, out, mode, act, p):
    """One launch of a matmul-epilogue library, as the wrapper makes it."""
    from mxnet_tpu_torch.kernels import _common
    from mxnet_tpu_torch.kernels import matmul_epilogue as me
    fn, bias_code = fn
    inv_keep = float(np.float32(1.0) / np.float32(1.0 - p))
    codes = [_common.DTYPE_CODE[y.dtype]] + (
        [_common.DTYPE_CODE[bias.dtype]] if bias_code else [])
    err = fn(y.data_ptr(), bias.data_ptr(),
             None if bits is None else bits.data_ptr(), out.data_ptr(),
             y.numel(), y.shape[1], mode, _common.ACT_CODE[act],
             *codes, me.keep_threshold(p), inv_keep,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        sys.exit(f"matmul_epilogue_launch returned {err}")


def compare_k2_bits(torch, other_fn, this_fn):
    """The two libraries on the same inputs; returns the number of cases
    and of cases that differ."""
    from mxnet_tpu_torch.kernels import _common
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = [((1024, 3072), 0), ((1024, 768), 0), ((64, 772), 0),
              ((77, 5), 0), ((3, 1), 0), ((64, 768), 1)]
    cases = differ = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for (r, c), offset in shapes:
            base = (torch.randn(r * c + offset, generator=gen, device=dev)
                    * 2).to(dtype)
            y = base[offset:].view(r, c)
            bits = torch.randint(0, 256, (r * c + offset,), generator=gen,
                                 device=dev, dtype=torch.uint8)[offset:] \
                .view(r, c)
            for mode, bshape in ((1, (1, c)), (2, (r, 1))):
                bias = (torch.randn(*bshape, generator=gen, device=dev)
                        * 0.5).to(dtype)
                for act in _common.EPILOGUE_ACTS:
                    for p in (0.0, 0.1):
                        kb = bits if p > 0 else None
                        outs = []
                        for fn in (other_fn, this_fn):
                            o = torch.empty(r, c, dtype=dtype, device=dev)
                            k2_call(torch, fn, y, bias, kb, o, mode, act, p)
                            outs.append(o)
                        torch.cuda.synchronize()
                        ints = {2: torch.int16, 4: torch.int32}[
                            y.element_size()]
                        same = torch.equal(outs[0].view(ints),
                                           outs[1].view(ints))
                        cases += 1
                        if not same:
                            differ += 1
                            print(f"K2 bits: {dtype} {(r, c)} offset "
                                  f"{offset} mode {mode} {act} p={p}: "
                                  "DIFFER")
    print(f"K2 bits: {cases} cases, {differ} differ (this tree's library "
          "against the other's, bit for bit)")
    return differ


def time_k2(torch, chip_smoke, fns, calls, dtype):
    """Each library's time for ``calls`` [(shape, act, p)] in turns
    other, this, this, other; returns {tag: [ms, ms]} and the bound."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    esize = torch.tensor([], dtype=dtype).element_size()
    per_shape = {}
    for shape, act, p in dict.fromkeys(calls):
        r, c = shape
        drop = p > 0
        n_copies = max(1, min(64, math.ceil(
            160e6 / chip_smoke.k2_bytes(shape, esize, "col", drop))))
        ys = [(torch.randn(r, c, generator=gen, device=dev) * 2).to(dtype)
              for _ in range(n_copies)]
        bias = (torch.randn(1, c, generator=gen, device=dev) * 0.5).to(dtype)
        bits = [torch.randint(0, 256, shape, generator=gen, device=dev,
                              dtype=torch.uint8) if drop else None
                for _ in range(n_copies)]
        outs = [torch.empty_like(t) for t in ys]
        per_shape[(shape, act, p)] = (ys, bias, bits, outs, n_copies)
    times = {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        total = 0.0
        for call in calls:
            ys, bias, bits, outs, n_copies = per_shape[call]
            total += chip_smoke.graph_ms(
                torch, lambda i: k2_call(torch, fns[tag], ys[i], bias,
                                         bits[i], outs[i], 1, call[1],
                                         call[2]), n_copies)
        times[tag].append(total)
    bound = sum(chip_smoke.k2_bound_ms(shape, esize, "col", p > 0, act)[0]
                for shape, act, p in calls)
    return times, bound


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the checkout to compare with")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    other, this = build(os.path.abspath(args.other), ROOT)
    same_bwd = compare_ptxas(chip_smoke, other, this)
    fns = {"other": k2_fn(other["matmul_epilogue"][0],
                          os.path.abspath(args.other)),
           "this": k2_fn(this["matmul_epilogue"][0], ROOT)}
    differ = compare_k2_bits(torch, fns["other"], fns["this"])
    rows = chip_smoke.SH_BERT["b"][0] * chip_smoke.SH_BERT["b"][1]
    bf16_calls = [((rows, 3072), "gelu", 0.0)] * 12 \
        + [((rows, 768), "identity", 0.1)] * 12
    fp32_calls = [(shape, act, 0.0) for _, shape, act in
                  chip_smoke.bert_epilogues(chip_smoke.BATCH)]
    for name, calls, dtype in (("bf16, MLM forward at batch 64, S 128, 24 "
                                "launches", bf16_calls, torch.bfloat16),
                               ("fp32, predict forward at batch 8, S 128, "
                                "25 launches", fp32_calls, torch.float32)):
        times, bound = time_k2(torch, chip_smoke, fns, calls, dtype)
        print(f"K2 times, {name}: other {times['other']} ms, this "
              f"{times['this']} ms (turns other, this, this, other); bytes "
              f"bound {bound:.6f} ms; share of the bound: other "
              f"{bound / min(times['other']):.3f}, this "
              f"{bound / min(times['this']):.3f}")
    if differ or not same_bwd:
        sys.exit(1)


if __name__ == "__main__":
    main()
