#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch, CUDA, nvcc and the card (fails without CUDA);
2. build every CUDA kernel from ``auron_tpu_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card;
4. drive the flagship q01 stage through ``auron_tpu_torch.entry.entry()``
   at 2^20 and 2^22 rows, with every launch counter set to 0 first, and
   check its output against the sort twin and a float64 numpy oracle;
5. time the kernels, their plain versions, one PyTorch library call, the
   stage and its sort twin with CUDA events (5 warm-up runs, median of
   50);
6. profile the kernel and the stage with torch.profiler: device time by
   kernel and the share of the wall time the device was busy.

The input is bench.py's measured distribution, made with numpy from seed
0: keys uniform on [0, 65536), v normal with 5% nulls, f uniform on
[0, 40). 2^22 rows also hold all 2,880,404 rows of TPC-DS SF1
store_sales in one batch.

Output: progress lines, then a JSON line of the stage's numbers, the
``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import batch_from_numpy
from auron_tpu_torch.entry import _DOMAIN, _q01_kernel_sort, entry
from auron_tpu_torch.kernels import _build
from auron_tpu_torch.kernels import grouped_agg as gagg

SIZES = (1 << 20, 1 << 22)
WARMUP, ITERS = 5, 50
SEED = 0

#: per-key tolerance of f32 sums, as a share of the key's sum of |v|:
#: f32 accumulation (2^-24 relative per add) of ~16-64 terms per key,
#: added in an order that changes from run to run
F32_SUM_TOL = 1e-5
#: the same for the float64 sort twin against the float64 oracle
F64_SUM_TOL = 1e-12

#: peak rates for the bound: f32 adds outside the tensor cores
F32_OPS_PER_S = 67e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def mem_bytes_per_s(name: str) -> float:
    """Device-memory rate of the card from its name (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12   # H100 SXM


def time_ms(fn) -> float:
    """Median over ITERS of one call, bracketed by CUDA events."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bench_columns(n: int, seed: int = SEED) -> dict:
    """bench.py's make_batch distribution, drawn in the same order."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 65536, size=n).astype(np.int64)
    v = rng.normal(size=n)
    f = rng.integers(0, 40, size=n).astype(np.int32)
    v_valid = rng.random(n) > 0.05
    return {"k": k, "v": v, "f": f, "v_valid": v_valid}


def stage_operands(host: dict, dev) -> tuple:
    """(k, v, c) as the flagship stage hands them to the kernel."""
    keep = (host["f"] > 10) & host["v_valid"]
    k = np.clip(host["k"], 0, _DOMAIN - 1).astype(np.int32)
    v = np.where(keep, host["v"], 0.0).astype(np.float32)
    c = keep.astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (k, v, c))


def abs_sums(k, v, key_domain: int) -> torch.Tensor:
    """Per-key sum of |v| in float64, the scale of each key's tolerance."""
    ok = (k >= 0) & (k < key_domain)
    return torch.zeros(key_domain, dtype=torch.float64, device=k.device) \
        .index_add_(0, k[ok].long(), v[ok].abs().double())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env() -> str:
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on the card and has no CPU mode")
    log("nvcc: " + run([_build._nvcc(), "--version"]).splitlines()[-1])
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    log(f"card: {card}; torch sees {torch.cuda.device_count()} "
        f"device(s), {torch.cuda.get_device_name(0)}")
    return card


def phase_build() -> float:
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {[p.name for p in libs]} in {build_s:.2f} s")
    return build_s


def kernel_cases(dev):
    """The five shapes the kernel is held to: (name, k, v, c,
    key_domain, exact) with ``exact`` where the sums must be identical."""
    rng = np.random.default_rng(1)
    n = SIZES[0]

    def tensors(k, v, valid):
        v = np.where(valid, v, 0.0).astype(np.float32)
        return (torch.from_numpy(k.astype(np.int32)).to(dev),
                torch.from_numpy(v).to(dev),
                torch.from_numpy(valid.astype(np.float32)).to(dev))

    keys = rng.integers(0, _DOMAIN, n)
    valid = rng.random(n) > 0.05
    yield ("random_f32", *tensors(keys, rng.normal(size=n), valid),
           _DOMAIN, False)
    yield ("integer_valued",
           *tensors(keys, rng.integers(-100, 100, n), valid), _DOMAIN, True)
    # all rows on one key: partial sums stay below 8 * 2^20 < 2^24
    yield ("single_group", *tensors(np.full(n, 37), rng.integers(-8, 8, n),
                                    np.ones(n, bool)), _DOMAIN, True)
    full = np.arange(_DOMAIN)
    yield ("full_domain", *tensors(full, full % 97,
                                   np.ones(_DOMAIN, bool)), _DOMAIN, True)
    oor = rng.integers(0, 1000, n)
    oor[rng.integers(0, n, 5000)] = rng.choice(
        [-1, 1000, 1500, 3000, 70000], 5000)
    yield ("out_of_range", *tensors(oor, rng.integers(-100, 100, n), valid),
           1000, True)


def phase_kernel_checks(dev) -> float:
    """cuda_sum_count against sum_count_reference on the card."""
    max_err = 0.0
    for name, k, v, c, dom, exact in kernel_cases(dev):
        sums, counts = gagg.cuda_sum_count(k, v, c, dom)
        ref_s, ref_c = gagg.sum_count_reference(k, v, c, dom)
        torch.cuda.synchronize()
        check(torch.equal(counts, ref_c), f"{name}: counts identical")
        err = (sums.double() - ref_s.double()).abs()
        if exact:
            check(torch.equal(sums, ref_s), f"{name}: sums identical")
        else:
            tol = F32_SUM_TOL * abs_sums(k, v, dom)
            check(bool((err <= tol).all()),
                  f"{name}: |dsum| <= {F32_SUM_TOL} * sum|v| per key")
        max_err = max(max_err, float(err.max()))
        log(f"kernel check {name}: rows {k.shape[0]}, key_domain {dom}, "
            f"max |dsum| {float(err.max()):.3e}: ok")
    return max_err


def groups(out) -> dict:
    """Valid groups of a stage output as numpy arrays sorted by key."""
    gk, gv, gs, gc, ga = (t.cpu().numpy() for t in out)
    order = np.argsort(gk[gv], kind="stable")
    return {"keys": gk[gv][order], "sums": gs[gv][order],
            "counts": gc[gv][order], "avg": ga[gv][order]}


def hold_stage(out, host: dict, label: str) -> tuple[dict, np.ndarray,
                                                     np.ndarray]:
    """The stage's output against a float64 oracle; returns its groups
    and the oracle's sums and sum of |v| for the same keys."""
    keep = (host["f"] > 10) & host["v_valid"]
    k, v = host["k"][keep], host["v"][keep]
    o_cnt = np.bincount(k, minlength=_DOMAIN)
    o_sum = np.bincount(k, weights=v, minlength=_DOMAIN)
    o_abs = np.bincount(k, weights=np.abs(v), minlength=_DOMAIN)
    present = np.nonzero(o_cnt)[0]

    dense = groups(out)
    check(np.array_equal(dense["keys"], present), f"{label}: group set")
    check(np.array_equal(dense["counts"], o_cnt[present]),
          f"{label}: counts vs oracle")
    check(bool(np.all(np.abs(dense["sums"] - o_sum[present])
                      <= F32_SUM_TOL * o_abs[present])),
          f"{label}: sums vs float64 oracle")
    return dense, o_sum[present], o_abs[present]


def phase_stage(dev) -> tuple[int, dict]:
    """The main path: entry()'s stage at each size, launch counts from 0."""
    fn, (example,) = entry()
    check(example.device.type == "cuda", "entry() runs on the card")
    ex, twin = groups(fn(example)), groups(_q01_kernel_sort(example))
    check(np.array_equal(ex["keys"], twin["keys"])
          and np.array_equal(ex["counts"], twin["counts"]),
          "entry()'s example batch: groups and counts vs sort twin")
    data = {n: bench_columns(n) for n in SIZES}
    batches = {}
    for n, host in data.items():
        ones = np.ones(n, np.bool_)
        batches[n] = batch_from_numpy(
            [(host["k"], ones), (host["v"], host["v_valid"]),
             (host["f"], ones)], n, dev)
    torch.cuda.synchronize()

    gagg.cuda_sum_count.launches = 0
    outs = {}
    for i, n in enumerate(SIZES, 1):
        outs[n] = fn(batches[n])
        check(gagg.cuda_sum_count.launches == i,
              f"stage at {n} rows launched cuda_dense_sum_count once")
    torch.cuda.synchronize()
    launches = gagg.cuda_sum_count.launches

    for n in SIZES:
        dense, o_sum, o_abs = hold_stage(outs[n], data[n], f"stage {n}")
        twin = groups(_q01_kernel_sort(batches[n]))
        check(np.array_equal(twin["keys"], dense["keys"]),
              f"stage {n}: group set vs sort twin")
        check(np.array_equal(twin["counts"], dense["counts"]),
              f"stage {n}: counts vs sort twin")
        check(bool(np.all(np.abs(twin["sums"] - dense["sums"])
                          <= F32_SUM_TOL * o_abs)),
              f"stage {n}: sums vs sort twin")
        check(bool(np.all(np.abs(twin["sums"] - o_sum)
                          <= F64_SUM_TOL * o_abs)),
              f"stage {n}: sort twin vs float64 oracle")
        log(f"stage {n} rows: {dense['keys'].size} groups, matches sort "
            f"twin and oracle")
    return launches, {"data": data, "batches": batches, "fn": fn}


def device_profile(fn, iters: int = 20) -> dict:
    """Per call: wall ms, device ms summed over CUDA kernels, the busy
    share of the device, and the kernels that took the most device time.
    The profiler's own cost is inside the wall time. Device numbers are
    None when the profiler saw no CUDA kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) \
                + e.self_device_time_total / 1e3 / iters
    device_ms = sum(by_kernel.values()) if by_kernel else None
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": None if device_ms is None else device_ms / wall_ms,
            "top_kernels_ms": [[name[:80], ms] for name, ms in top]}


def phase_profile(dev, stage: dict) -> dict:
    out = {}
    for n in SIZES:
        k, v, c = stage_operands(stage["data"][n], dev)
        kern = device_profile(lambda: gagg.cuda_sum_count(k, v, c, _DOMAIN))
        mine = [ms for name, ms in kern["top_kernels_ms"]
                if "dense_sum_count" in name]
        kern["dense_sum_count_ms"] = mine[0] if mine else None
        batch = stage["batches"][n]
        out[n] = {"kernel": kern,
                  "stage": device_profile(lambda: stage["fn"](batch))}
        log(f"profile at {n} rows: {json.dumps(out[n])}")
    return out


def bound_ms(rows: int, key_domain: int, rate: float) -> tuple[float, str]:
    """Least time for the function: 12 B/row in and 8 B/key out at the
    memory rate, or 2 f32 adds/row at the f32 rate, whichever is longer."""
    by_bytes = (12 * rows + 8 * key_domain) / rate * 1e3
    by_ops = 2 * rows / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase_times(dev, stage: dict, rate: float) -> tuple[list, dict]:
    def library(k, v, c):
        s = torch.zeros(_DOMAIN, dtype=torch.float32, device=dev)
        cn = torch.zeros(_DOMAIN, dtype=torch.float32, device=dev)
        s.index_add_(0, k, v)
        cn.index_add_(0, k, c)

    launches_before = gagg.cuda_sum_count.launches
    per_size, stage_times = [], []
    for n in SIZES:
        k, v, c = stage_operands(stage["data"][n], dev)
        bnd, by = bound_ms(n, _DOMAIN, rate)
        row = {"rows": n, "key_domain": _DOMAIN,
               "ms": time_ms(lambda: gagg.cuda_sum_count(k, v, c, _DOMAIN)),
               "plain_ms": time_ms(
                   lambda: gagg.sum_count_reference(k, v, c, _DOMAIN)),
               "library_ms": time_ms(lambda: library(k, v, c)),
               "bound_ms": bnd, "bound_by": by}
        per_size.append(row)
        log(f"kernel at {n} rows: {json.dumps(row)}")
        batch = stage["batches"][n]
        st_ms = time_ms(lambda: stage["fn"](batch))
        sort_ms = time_ms(lambda: _q01_kernel_sort(batch))
        stage_times.append({"rows": n, "stage_ms": st_ms,
                            "stage_rows_per_s": n / (st_ms / 1e3),
                            "sort_twin_ms": sort_ms,
                            "sort_twin_rows_per_s": n / (sort_ms / 1e3)})
        log(f"stage at {n} rows: {json.dumps(stage_times[-1])}")

    n = SIZES[0]
    k = torch.full((n,), 37, dtype=torch.int32, device=dev)
    v = torch.ones(n, dtype=torch.float32, device=dev)
    single = {"rows": n, "ms": time_ms(
        lambda: gagg.cuda_sum_count(k, v, v, _DOMAIN)),
        "plain_ms": time_ms(lambda: gagg.sum_count_reference(k, v, v,
                                                             _DOMAIN)),
        "bound_ms": bound_ms(n, _DOMAIN, rate)[0]}
    log(f"single group at {n} rows: {json.dumps(single)}")
    check(gagg.cuda_sum_count.launches > launches_before,
          "timed runs launched the kernel")
    return per_size, {"stages": stage_times, "single_group": single}


def main() -> int:
    card = phase_env()
    dev = torch.device("cuda")
    build_s = phase_build()
    max_err = phase_kernel_checks(dev)
    launches, stage = phase_stage(dev)
    name = torch.cuda.get_device_name(0)
    rate = mem_bytes_per_s(name)
    per_size, other = phase_times(dev, stage, rate)
    prof = phase_profile(dev, stage)
    for row in per_size:
        row["device_ms"] = prof[row["rows"]]["kernel"]["dense_sum_count_ms"]

    head = per_size[0]
    kernel = {
        "name": "cuda_dense_sum_count", "route": "cuda",
        "source": "auron_tpu_torch/kernels/csrc/grouped_agg.cu",
        "replaces": "auron_tpu/kernels/grouped_agg.py:98",
        "replaces_kernel": "_vmem_agg_kernel",
        "launches": launches, "launches_per_stage": 1,
        "max_abs_err": max_err, "max_err": max_err,
        "ms": head["ms"], "kernel_ms": head["ms"],
        "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
        "library_call": "2x Tensor.index_add_",
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "rows": head["rows"], "key_domain": _DOMAIN,
        "mem_bytes_per_s": rate, "by_rows": per_size,
        "single_group": other["single_group"],
    }
    print(json.dumps({"build_s": build_s, "stages": other["stages"],
                      "profile": {str(n): p for n, p in prof.items()},
                      "card": card}))
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
